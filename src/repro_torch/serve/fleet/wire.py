"""Versioned wire format for :class:`~repro_torch.serve.streaming.StreamState`.

A live stream is the fleet's unit of work — hidden state, step/window
counters, every buffered-but-unconsumed sample, and the trajectory tap.
``export_stream`` / ``import_stream`` make that state portable
in-process; this module makes it portable across processes and crashes: ``encode_stream_state`` serializes a snapshot to deterministic
bytes and ``decode_stream_state`` reconstructs it bit-exactly, so a
replacement shard can resume the stream with outputs byte-identical to an
uninterrupted engine (the failover contract in ``serve/fleet/engine.py``).

The format reuses the ``.fgar`` idiom from ``compress/artifact.py`` —
canonical-JSON header + raw little-endian payload — with a stream-sized
preamble::

  +----------+------------------------------------------------------------+
  | preamble | ``FGSS``, u8 major, u8 minor, u32 header length,           |
  |          | u32 header crc32                                           |
  | header   | canonical JSON (sorted keys, compact separators): stream   |
  |          | identity + counters, per-tensor manifest (name, dtype,     |
  |          | shape), payload length + crc32                             |
  | payload  | raw little-endian float32 tensor bytes, manifest order     |
  |          | (``h``, then ``samples``, then ``trajectory``)             |
  +----------+------------------------------------------------------------+

The port of the reference's ``repro.serve.fleet.wire``: the two packages
encode byte-identical blobs and decode each other's
(``tests/test_torch_wire.py``).

Determinism contract:

  * encode -> decode -> encode is byte-identical (canonical JSON pins key
    order and separators; tensors are serialized in one fixed order);
  * every truncation and every single-bit corruption of a valid blob
    raises a typed :class:`WireError` — never a silently-wrong
    ``StreamState`` (both the header and the payload carry a crc32, so a
    flipped counter bit is as detectable as a flipped sample bit).

Version policy: ``major`` changes are incompatible layout changes and are
rejected outright; ``minor`` changes are additive, so a reader rejects
only *newer* minors than it knows (``WIRE_MINOR``) — an old blob always
decodes, a blob from a newer writer fails with an explicit upgrade
message instead of dropping fields it cannot see.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from repro_torch.compress.artifact import jsonify
from repro_torch.serve.streaming import StreamState

MAGIC = b"FGSS"
WIRE_MAJOR = 1
WIRE_MINOR = 0

# magic, major, minor, header length, header crc32
_PREAMBLE = struct.Struct("<4sBBII")

# Tensors serialized in this fixed order (determinism: the manifest and
# payload cannot reorder between encodes of the same state):
_TENSORS = ("h", "samples", "trajectory")
_DTYPE = np.dtype("<f4")


class WireError(ValueError):
    """Base error for StreamState wire-format failures."""


class WireVersionError(WireError):
    """The blob's wire version is not decodable by this reader."""


class WireTruncatedError(WireError):
    """The blob ends before the structure it declares is complete."""


class WireCorruptError(WireError):
    """The blob is complete but fails an integrity check (crc32 or
    manifest/payload consistency)."""


def _canonical_json(obj) -> bytes:
    return json.dumps(jsonify(obj), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def encode_stream_state(state: StreamState) -> bytes:
    """Serialize a :class:`StreamState` to deterministic wire bytes."""
    h = np.ascontiguousarray(np.asarray(state.h, np.float32))
    samples = np.ascontiguousarray(np.asarray(state.samples, np.float32))
    if samples.ndim != 2:
        raise WireError(
            f"stream {state.stream_id!r}: samples must be 2-d (k, d), "
            f"got shape {samples.shape}")
    traj_rows = list(state.trajectory)
    traj = (np.ascontiguousarray(np.stack(traj_rows).astype(np.float32))
            if traj_rows else np.zeros((0, h.shape[-1]), np.float32))
    tensors = {"h": h, "samples": samples, "trajectory": traj}
    payload = b"".join(tensors[name].astype(_DTYPE, copy=False).tobytes()
                       for name in _TENSORS)
    header = _canonical_json({
        "stream": {
            "id": state.stream_id,
            "steps": int(state.steps),
            "wstep": int(state.wstep),
            "total": None if state.total is None else int(state.total),
            "record_trajectory": bool(state.record_trajectory),
        },
        "tensors": [{"name": name, "dtype": "<f4",
                     "shape": list(tensors[name].shape)}
                    for name in _TENSORS],
        "payload": {"bytes": len(payload),
                    "crc32": zlib.crc32(payload) & 0xFFFFFFFF},
    })
    preamble = _PREAMBLE.pack(MAGIC, WIRE_MAJOR, WIRE_MINOR, len(header),
                              zlib.crc32(header) & 0xFFFFFFFF)
    return preamble + header + payload


def decode_stream_state(blob: bytes) -> StreamState:
    """Reconstruct a :class:`StreamState` from wire bytes, or raise a
    typed :class:`WireError` (version / truncation / corruption) — never
    return a partially-decoded state."""
    blob = bytes(blob)
    if len(blob) < _PREAMBLE.size:
        raise WireTruncatedError(
            f"StreamState blob is {len(blob)} bytes; the preamble alone "
            f"is {_PREAMBLE.size}")
    magic, major, minor, hlen, hcrc = _PREAMBLE.unpack_from(blob, 0)
    if magic != MAGIC:
        raise WireError(
            f"not a StreamState blob: magic {magic!r} != {MAGIC!r}")
    if major != WIRE_MAJOR:
        raise WireVersionError(
            f"unsupported StreamState wire major version {major} "
            f"(this reader supports major {WIRE_MAJOR})")
    if minor > WIRE_MINOR:
        raise WireVersionError(
            f"StreamState blob written by a newer minor version "
            f"{major}.{minor} (this reader supports up to "
            f"{WIRE_MAJOR}.{WIRE_MINOR}); upgrade the reader to decode it")
    hstart, hend = _PREAMBLE.size, _PREAMBLE.size + hlen
    if len(blob) < hend:
        raise WireTruncatedError(
            f"StreamState header declares {hlen} bytes but only "
            f"{len(blob) - hstart} are present")
    header_bytes = blob[hstart:hend]
    if (zlib.crc32(header_bytes) & 0xFFFFFFFF) != hcrc:
        raise WireCorruptError("StreamState header crc32 mismatch")
    try:
        header = json.loads(header_bytes.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireCorruptError(f"StreamState header is not valid "
                               f"canonical JSON: {e}") from e
    try:
        stream = header["stream"]
        manifest = header["tensors"]
        declared = header["payload"]
        nbytes, pcrc = int(declared["bytes"]), int(declared["crc32"])
    except (KeyError, TypeError) as e:
        raise WireCorruptError(
            f"StreamState header is missing required field: {e}") from e
    payload = blob[hend:]
    if len(payload) < nbytes:
        raise WireTruncatedError(
            f"StreamState payload declares {nbytes} bytes but only "
            f"{len(payload)} are present")
    if len(payload) > nbytes:
        raise WireError(
            f"StreamState blob has {len(payload) - nbytes} trailing bytes "
            "after the declared payload")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != pcrc:
        raise WireCorruptError("StreamState payload crc32 mismatch")
    names = [t.get("name") for t in manifest]
    if names != list(_TENSORS):
        raise WireCorruptError(
            f"StreamState manifest order {names} != expected "
            f"{list(_TENSORS)}")
    tensors: dict[str, np.ndarray] = {}
    offset = 0
    for t in manifest:
        if t.get("dtype") != "<f4":
            raise WireCorruptError(
                f"tensor {t.get('name')!r}: unsupported dtype "
                f"{t.get('dtype')!r}")
        shape = tuple(int(s) for s in t["shape"])
        size = int(np.prod(shape, dtype=np.int64)) * _DTYPE.itemsize
        if offset + size > nbytes:
            raise WireCorruptError(
                f"tensor {t['name']!r} extends past the declared payload")
        tensors[t["name"]] = np.frombuffer(
            payload, _DTYPE, count=size // _DTYPE.itemsize,
            offset=offset).reshape(shape).copy()
        offset += size
    if offset != nbytes:
        raise WireCorruptError(
            f"StreamState manifest accounts for {offset} payload bytes "
            f"but {nbytes} are declared")
    traj = tensors["trajectory"]
    return StreamState(
        stream_id=str(stream["id"]),
        h=tensors["h"],
        steps=int(stream["steps"]),
        wstep=int(stream["wstep"]),
        total=None if stream["total"] is None else int(stream["total"]),
        samples=tensors["samples"],
        record_trajectory=bool(stream["record_trajectory"]),
        trajectory=[traj[i].copy() for i in range(traj.shape[0])])
