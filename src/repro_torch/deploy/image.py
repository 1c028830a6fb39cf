"""Packed weight image: the deployable artifact (paper Sec. V-B, Table I),
ported from the reference ``repro.deploy.image``.

``build_image`` lowers a calibrated
:class:`repro_torch.compress.ModelArtifact` into a :class:`DeployImage`;
``DeployImage.to_bytes`` serializes it into a deterministic, versioned byte image mirroring what gets flashed next to the
paper's ~200-line C translation unit:

  +--------+----------------------------------------------------------+
  | header | magic "FGRN", version, bits, flags, dims (d,H,C,rw,ru)   |
  | q      | int16 Q15 weight tensors, canonical order, row-major LE  |
  | scales | one f32 per weight tensor, same order                    |
  | consts | b_z, b_h (H f32 each), head_b (C f32), zeta, nu (raw f32)|
  | acts   | 6 f32 activation scales (x, wx1, uh1, pre, h, logits)    |
  | luts   | sigmoid + tanh as 256 x int16 Q15 (integer engine, 1 KB) |
  |        | then as 256 x f32 (float engine — the paper's 2 KB pair) |
  +--------+----------------------------------------------------------+

Determinism contract: two exports of the same checkpoint are byte-identical
(fixed tensor order via ``QuantizedParams.tensor_order``, fixed activation-
scale order, little-endian, no timestamps), and byte-identical to the
reference package's image of the same artifact
(``tests/test_torch_deploy.py``).  The image is NumPy: the port's
quantized tensors (CPU tensors) are read through ``np.asarray``.

Size audit: ``audit_platforms`` checks the image + the integer engine's
SRAM working set against ``core/mcu.PLATFORMS`` flash/SRAM budgets for the
paper's two targets (AVR ATmega328P, MSP430G2553) — export fails loudly
rather than shipping an unflashable image.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np

from repro_torch.core import mcu
from repro_torch.core.lut import LUT_SIZE, make_lut, make_lut_q15
from repro_torch.core.quantization import QuantizedParams

MAGIC = b"FGRN"
IMAGE_VERSION = 1
# Activation-scale slots, fixed order.  wx1/uh1 are the low-rank
# intermediates (W2^T x, U2^T h); zero for full-rank models.
ACT_KEYS = ("x", "wx1", "uh1", "pre", "h", "logits")

_HEADER = struct.Struct("<4sHBBHHHHHH")   # magic, ver, bits, flags, d,H,C,rw,ru,ntens


@dataclasses.dataclass
class DeployImage:
    """In-memory form of the packed weight image."""
    version: int
    bits: int
    low_rank: bool
    d: int
    H: int
    C: int
    rank_w: int                     # 0 = full rank
    rank_u: int
    q: dict[str, np.ndarray]        # name -> int16, canonical order
    scales: dict[str, float]        # name -> f32 dequant scale
    b_z: np.ndarray                 # (H,) f32
    b_h: np.ndarray                 # (H,) f32
    head_b: np.ndarray              # (C,) f32
    zeta_raw: float                 # pre-sigmoid scalars, as checkpointed
    nu_raw: float
    act_scales: dict[str, float]    # ACT_KEYS -> f32
    sig_lut: np.ndarray             # (256,) int16 Q15 (integer engine)
    tanh_lut: np.ndarray            # (256,) int16 Q15
    sig_lut_f32: np.ndarray         # (256,) f32 (float engine, paper's 2 KB)
    tanh_lut_f32: np.ndarray        # (256,) f32

    # -- canonical tensor geometry --------------------------------------
    def tensor_order(self) -> tuple[str, ...]:
        if self.low_rank:
            return ("W1", "W2", "U1", "U2", "head_w")
        return ("W", "U", "head_w")

    def tensor_shape(self, name: str) -> tuple[int, int]:
        d, H, C = self.d, self.H, self.C
        return {
            "W": (H, d), "U": (H, H),
            "W1": (H, self.rank_w), "W2": (d, self.rank_w),
            "U1": (H, self.rank_u), "U2": (H, self.rank_u),
            "head_w": (H, C),
        }[name]

    # -- serialization ---------------------------------------------------
    def to_bytes(self) -> bytes:
        order = self.tensor_order()
        out = [_HEADER.pack(MAGIC, self.version, self.bits,
                            1 if self.low_rank else 0,
                            self.d, self.H, self.C,
                            self.rank_w, self.rank_u, len(order))]
        for name in order:
            t = np.ascontiguousarray(self.q[name], dtype="<i2")
            if t.shape != self.tensor_shape(name):
                raise ValueError(f"{name}: shape {t.shape} != "
                                 f"{self.tensor_shape(name)}")
            out.append(t.tobytes())
        out.append(np.asarray([self.scales[n] for n in order],
                              "<f4").tobytes())
        out.append(np.asarray(self.b_z, "<f4").tobytes())
        out.append(np.asarray(self.b_h, "<f4").tobytes())
        out.append(np.asarray(self.head_b, "<f4").tobytes())
        out.append(np.asarray([self.zeta_raw, self.nu_raw], "<f4").tobytes())
        out.append(np.asarray([self.act_scales.get(k, 0.0) for k in ACT_KEYS],
                              "<f4").tobytes())
        out.append(np.ascontiguousarray(self.sig_lut, "<i2").tobytes())
        out.append(np.ascontiguousarray(self.tanh_lut, "<i2").tobytes())
        out.append(np.ascontiguousarray(self.sig_lut_f32, "<f4").tobytes())
        out.append(np.ascontiguousarray(self.tanh_lut_f32, "<f4").tobytes())
        return b"".join(out)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "DeployImage":
        magic, ver, bits, flags, d, H, C, rw, ru, ntens = _HEADER.unpack_from(blob, 0)
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        if ver != IMAGE_VERSION:
            raise ValueError(f"unsupported image version {ver}")
        img = cls(version=ver, bits=bits, low_rank=bool(flags & 1),
                  d=d, H=H, C=C, rank_w=rw, rank_u=ru,
                  q={}, scales={}, b_z=None, b_h=None, head_b=None,
                  zeta_raw=0.0, nu_raw=0.0, act_scales={},
                  sig_lut=None, tanh_lut=None,
                  sig_lut_f32=None, tanh_lut_f32=None)
        order = img.tensor_order()
        if len(order) != ntens:
            raise ValueError(f"tensor count {ntens} != expected {len(order)}")
        off = _HEADER.size

        def take(dtype, n):
            nonlocal off
            a = np.frombuffer(blob, dtype, count=n, offset=off)
            off += a.nbytes
            return a

        for name in order:
            shape = img.tensor_shape(name)
            img.q[name] = take("<i2", int(np.prod(shape))).reshape(shape).copy()
        sc = take("<f4", len(order))
        img.scales = {n: float(s) for n, s in zip(order, sc)}
        img.b_z = take("<f4", H).astype(np.float32)
        img.b_h = take("<f4", H).astype(np.float32)
        img.head_b = take("<f4", C).astype(np.float32)
        zn = take("<f4", 2)
        img.zeta_raw, img.nu_raw = float(zn[0]), float(zn[1])
        ac = take("<f4", len(ACT_KEYS))
        img.act_scales = {k: float(v) for k, v in zip(ACT_KEYS, ac)}
        img.sig_lut = take("<i2", LUT_SIZE).copy()
        img.tanh_lut = take("<i2", LUT_SIZE).copy()
        img.sig_lut_f32 = take("<f4", LUT_SIZE).astype(np.float32)
        img.tanh_lut_f32 = take("<f4", LUT_SIZE).astype(np.float32)
        if off != len(blob):
            raise ValueError(f"trailing bytes: {len(blob) - off}")
        return img

    # -- memory accounting ----------------------------------------------
    def weight_bytes(self) -> int:
        """Q15 weight payload — the paper's '566-byte' figure analog."""
        return sum(int(np.prod(self.tensor_shape(n))) * 2
                   for n in self.tensor_order())

    def lut_bytes(self, engine: str = "both") -> int:
        """LUT flash: the float engine carries the paper's 2 KB f32 pair,
        the integer engine a 1 KB int16 pair; the image packs both."""
        f32, i16 = 2 * LUT_SIZE * 4, 2 * LUT_SIZE * 2
        return {"float": f32, "int": i16, "both": f32 + i16}[engine]

    def const_bytes(self) -> int:
        """Scales, biases, scalars, activation scales (f32 each)."""
        return 4 * (len(self.tensor_order()) + 2 * self.H + self.C + 2
                    + len(ACT_KEYS))

    def nbytes(self) -> int:
        return _HEADER.size + self.weight_bytes() + self.lut_bytes() \
            + self.const_bytes()

    def engine_flash_bytes(self, engine: str) -> int:
        """Flash footprint of ONE deployed engine's data (what a single
        target actually carries: weights + its LUT format + constants)."""
        return self.weight_bytes() + self.lut_bytes(engine) + self.const_bytes()

    def sram_needed(self, engine: str = "float") -> int:
        """Runtime working set.  ``float``: the paper's engine (~300 B of
        f32 h/pre/z/h~/logits + scratch).  ``int``: int16 state + int32
        fine intermediates — leaner despite the wider scratch."""
        r = max(self.rank_w, self.rank_u, 1)
        if engine == "float":
            f32s = 4 * self.H + self.C + max(r, self.d)  # h,pre,z,h~,logits,t
            return f32s * 4 + 48
        int16s = self.H + self.d                  # h, x
        int32s = self.H + r + self.C              # pre, t-scratch, logits
        return int16s * 2 + int32s * 4 + 64


def build_image(artifact) -> DeployImage:
    """Lower a calibrated model into the packed image form.

    ``artifact`` is a :class:`repro_torch.compress.ModelArtifact` carrying
    quantized params + deploy calibration scales (a ``QuantizePTQ`` pass
    followed by ``CalibrateActivations(scope="deploy")``).  A bare
    ``QuantizedParams`` is refused: wrap a ``(qp, act_scales)`` pair as
    ``ModelArtifact(qp=qp, act_scales=act_scales)``.

    Q15 (bits=16) gives the reference's image byte for byte.  Q7
    (bits=8) packs the int8-range weights into the same int16 cell layout
    with ``bits=8`` in the header, so the qvm / emitted C consume both
    widths through one quantization plan (scales absorb the width).
    """
    if isinstance(artifact, QuantizedParams):
        raise TypeError(
            "build_image(qp, act_scales) was removed; pass a "
            "repro_torch.compress.ModelArtifact (QuantizePTQ -> "
            "CalibrateActivations(scope='deploy')), or wrap the pair as "
            "ModelArtifact(qp=qp, act_scales=act_scales)")
    if getattr(artifact, "qp", None) is None:
        raise ValueError("build_image needs a ModelArtifact with "
                         "quantized params (run QuantizePTQ first)")
    act_scales = artifact.act_scales
    qp = artifact.qp
    if qp.bits not in (16, 8):
        raise ValueError(f"export supports Q15 (bits=16) and Q7 (bits=8) "
                         f"weights, got bits={qp.bits}")
    low_rank = "W1" in qp.q
    need = {"x", "pre", "h", "logits"} | ({"wx1", "uh1"} if low_rank else set())
    missing = need - set(act_scales or {})
    if missing:
        raise ValueError(f"act_scales missing {sorted(missing)} — use "
                         "core.qruntime.calibrate(..., deploy=True) (the "
                         "CalibrateActivations(scope='deploy') pass), "
                         "not the storage calibration")
    names = ("W1", "W2", "U1", "U2", "head_w") if low_rank else ("W", "U", "head_w")
    q = {n: np.asarray(qp.q[n], np.int16) for n in names}
    # round every scalar constant to f32 AT BUILD TIME: the serialized
    # image stores f32, and the quantization plan (requant multipliers)
    # must be identical whether derived from a live or a reloaded image
    f32 = lambda v: float(np.float32(np.asarray(v)))
    scales = {n: f32(qp.scales[n]) for n in names}
    H = q["head_w"].shape[0]
    d = q["W2"].shape[0] if low_rank else q["W"].shape[1]
    C = q["head_w"].shape[1]
    return DeployImage(
        version=IMAGE_VERSION, bits=qp.bits, low_rank=low_rank,
        d=d, H=H, C=C,
        rank_w=q["W1"].shape[1] if low_rank else 0,
        rank_u=q["U1"].shape[1] if low_rank else 0,
        q=q, scales=scales,
        b_z=np.asarray(qp.fp["b_z"], np.float32),
        b_h=np.asarray(qp.fp["b_h"], np.float32),
        head_b=np.asarray(qp.fp["head_b"], np.float32),
        zeta_raw=f32(qp.fp["zeta"]), nu_raw=f32(qp.fp["nu"]),
        act_scales={k: f32(act_scales.get(k, 0.0)) for k in ACT_KEYS},
        sig_lut=make_lut_q15("sigmoid").numpy(),
        tanh_lut=make_lut_q15("tanh").numpy(),
        sig_lut_f32=make_lut("sigmoid").numpy(),
        tanh_lut_f32=make_lut("tanh").numpy())


def export_model(artifact,
                 path: str | None = None) -> tuple[DeployImage, bytes]:
    """One-call export: build, serialize, optionally write ``path``.
    ``artifact`` is a calibrated :class:`repro_torch.compress.ModelArtifact`."""
    img = build_image(artifact)
    blob = img.to_bytes()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return img, blob


def size_report(img: DeployImage) -> dict[str, Any]:
    return {
        "image_version": img.version,
        "bits": img.bits,
        "arch": {"d": img.d, "H": img.H, "C": img.C,
                 "rank_w": img.rank_w, "rank_u": img.rank_u,
                 "low_rank": img.low_rank},
        "header_bytes": _HEADER.size,
        "weight_bytes": img.weight_bytes(),
        "lut_bytes": {"float_engine": img.lut_bytes("float"),
                      "int_engine": img.lut_bytes("int")},
        "const_bytes": img.const_bytes(),
        "total_bytes": img.nbytes(),
        "engine_flash_bytes": {e: img.engine_flash_bytes(e)
                               for e in ("float", "int")},
        "sram_needed": {e: img.sram_needed(e) for e in ("float", "int")},
        "tensors": [{"name": n, "shape": img.tensor_shape(n),
                     "scale": img.scales[n]} for n in img.tensor_order()],
    }


def audit_platforms(img: DeployImage,
                    platforms: tuple[str, ...] = ("avr", "msp430"),
                    engine: str = "float") -> dict[str, Any]:
    """Assert one deployed engine's flash/SRAM needs fit every requested
    platform budget.  Defaults to the paper's float engine (the larger of
    the two working sets); the integer engine is strictly leaner on SRAM."""
    return {key: mcu.audit_budget(img.engine_flash_bytes(engine),
                                  img.sram_needed(engine), mcu.platform(key))
            for key in platforms}
