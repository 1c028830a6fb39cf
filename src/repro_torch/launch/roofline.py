"""Roofline terms for one (arch x shape x mesh) cell on the H100 (reference
``repro.launch.roofline``), in seconds per device:

  compute    = FLOPs per device            / the bf16 dense peak
  memory     = HBM bytes per device        / the HBM3 rate
  collective = collective bytes per device / one direction of NVLink 4

The reference reads its collective bytes from compiled HLO text
(``parse_collectives``: the operand bytes of every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute, the ops
inside a while loop multiplied by its trip count).  A torch step makes no
HLO, so the port keeps ``parse_collectives`` as a pure function over the
reference's text format, equal to the reference's on the same strings,
and counts a step's collectives where they are issued:
``launch/dryrun.py`` runs the step as rank 0 of a fake process group and
sums the operand bytes of every c10d collective it dispatches, by the
same kinds, into ``collective_bytes_per_device`` (one card: 0).
``Roofline``'s per-device terms are the reference's; only the three
rates are the H100's in place of the TPU v5e's.
"""
from __future__ import annotations

import dataclasses
import re

# NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at the 700 W
# limit).  This module is the port's one home of these figures: the
# kernels' bounds in ``chip_smoke.py`` and ``kernels/fastgrnn_cell/ops.py``
# read them from here.
BF16_FLOP_PER_S = 989e12       # bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
# one direction of NVLink 4: half of the 900 GB/s aggregate of a card's
# 18 links, the rate a collective's payload leaves (or reaches) one card
NVLINK_BYTES_PER_S = 450e9
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
# the card's HBM3: 80 GiB, what a rank's step must fit in
HBM_BYTES = 80 * 2**30
# float32 instructions per second outside the tensor cores: the 67 TFLOP/s
# count an FMA as two operations, so one instruction (an FMA, an add or a
# multiply) issues at half that rate (132 SMs x 128 lanes x ~1.98 GHz).
# The FastGRNN kernels round between each multiply and add, so each is an
# instruction of its own there.
FP32_OPS_PER_S = FP32_FLOP_PER_S / 2

# the roofline's three rates, under the reference's names
PEAK_FLOPS = BF16_FLOP_PER_S
HBM_BW = HBM_BYTES_PER_S

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# "%name = bf16[8,128]{1,0} op-name(operands...)" or tuple types
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)\)")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (handles tuples by summing)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict
    unknown_trip_whiles: int = 0

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


# NB: computation headers may contain "/*index=5*/" comments inside the
# parameter tuple — the param group must tolerate '='.
_COMP_HDR_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\(.*\))?\s*->.*\{")
_ATTR_RE = re.compile(r"(\w+)=%?([\w.\-]+)")


def _split_computations(hlo_text: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur = None
    entry_alias = None
    for line in hlo_text.splitlines():
        if "->" in line and line.rstrip().endswith("{"):
            m = _COMP_HDR_RE.match(line)
            if m:
                cur = m.group(1)
                comps[cur] = []
                if line.lstrip().startswith("ENTRY"):
                    entry_alias = cur
                continue
        if cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    if entry_alias:
        comps["__entry__"] = comps[entry_alias]
    return comps


def _trip_count(cond_lines: list[str]) -> int | None:
    """jax scans lower to while(cond: ind_var < constant)."""
    consts: dict[str, int] = {}
    for line in cond_lines:
        m = re.match(r"\s*%?([\w.\-]+)\s*=\s*\w+\[\]\s*constant\((\d+)\)", line)
        if m:
            consts[m.group(1)] = int(m.group(2))
    for line in cond_lines:
        if "compare(" in line and ("direction=LT" in line or "direction=GT" in line):
            for ref in re.findall(r"%([\w.\-]+)", line.split("compare(", 1)[1]):
                if ref in consts:
                    return consts[ref]
    if len(consts) == 1:
        return next(iter(consts.values()))
    return None


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum operand bytes of every collective op, multiplying ops inside
    while-loop bodies by the loop trip count (recursively).  This is what
    makes scanned-layer HLO collective accounting correct — XLA's own
    cost_analysis does NOT do this."""
    comps = _split_computations(hlo_text)
    # global shape table (instruction names are unique enough across comps)
    shapes: dict[str, str] = {}
    for lines in comps.values():
        for line in lines:
            m = _INSTR_RE.match(line)
            if m:
                shapes[m.group(1)] = m.group(2)

    counts: dict[str, int] = {}
    byts: dict[str, int] = {}
    unknown = [0]

    def visit(comp_name: str, mult: float, seen: tuple = ()):
        if comp_name not in comps or comp_name in seen:
            return
        for line in comps[comp_name]:
            m = _INSTR_RE.match(line)
            if not m:
                continue
            _, _, op, operands = m.groups()
            base = op.rstrip("0123456789.")
            attrs = dict(_ATTR_RE.findall(line))
            matched = None
            for coll in _COLLECTIVES:
                if base == coll or base == coll + "-start":
                    matched = coll
                    break
            if matched:
                b = 0
                for ref in re.findall(r"%([\w.\-]+)", operands):
                    if ref in shapes:
                        b += _shape_bytes(shapes[ref])
                if b == 0:
                    b = _shape_bytes(operands)
                counts[matched] = counts.get(matched, 0) + int(mult)
                byts[matched] = byts.get(matched, 0) + int(b * mult)
            elif base == "while":
                body = attrs.get("body")
                cond = attrs.get("condition")
                trip = _trip_count(comps.get(cond, [])) if cond else None
                if trip is None:
                    trip = 1
                    unknown[0] += 1
                visit(body, mult * trip, seen + (comp_name,))
            elif base in ("call", "fusion", "conditional", "custom-call"):
                for key in ("to_apply", "called_computations", "true_computation",
                            "false_computation", "branch_computations"):
                    if key in attrs:
                        visit(attrs[key], mult, seen + (comp_name,))
    visit("__entry__", 1.0)
    return CollectiveStats(counts=counts, bytes_by_kind=byts,
                           unknown_trip_whiles=unknown[0])


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    chips: int

    @classmethod
    def from_cost(cls, cost, kind: str, *, pods: int, data: int, model: int,
                  collective_bytes_per_device: float,
                  model_flops_global: float,
                  weight_shards: int | None = None) -> "Roofline":
        """Build roofline terms from the analytic CellCost + parsed
        collectives, applying the sharding split factors:
          * compute: fully parallel over all chips;
          * weights: FSDP all-gathers mean each chip READS 1/tp of every
            weight per pass (passes = 3 for train: fwd/remat/bwd);
          * activations: sharded over the batch axes (pod x data);
          * decode caches + optimizer state: sharded over all chips
            (opt not sharded over pods -> data x model)."""
        chips = pods * data * model
        passes = 3.0 if kind == "train" else 1.0
        weight_dev = cost.weight_bytes_per_pass * passes / (weight_shards or model)
        # activations shard over the batch axes; under sequence parallelism
        # (weight_shards == 1) they shard over `model` too.  For TP runs
        # this is conservative (FFN/attn intermediates ARE model-sharded,
        # the residual stream is not).
        act_shards = pods * data * (model if weight_shards == 1 else 1)
        act_dev = cost.act_bytes / act_shards
        cache_dev = cost.cache_bytes / chips
        opt_dev = cost.opt_bytes / (data * model)
        return cls(
            flops_per_device=cost.flops_total / chips,
            bytes_per_device=weight_dev + act_dev + cache_dev + opt_dev,
            collective_bytes_per_device=collective_bytes_per_device,
            model_flops_global=model_flops_global,
            chips=chips,
        )

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total HLO FLOPs — catches remat/redundancy waste."""
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of the compute roofline at the bound:
        useful-FLOPs time / bound time."""
        t_useful = self.model_flops_global / (self.chips * PEAK_FLOPS)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }
