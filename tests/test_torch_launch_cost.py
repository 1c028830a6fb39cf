"""The port's analytic cost model and roofline (``launch/analytic.py``,
``launch/roofline.py``) against the reference's: ``cell_cost`` equal
(``==``) for every applicable (arch x shape), the roofline's per-device
terms equal and each time the reference's scaled by the ratio of the two
machines' rates, ``parse_collectives`` equal on HLO text compiled here by
JAX on the test process's 8 host devices, and the pipeline and
compression ratios equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro.configs as JC
from repro.launch import analytic as JA
from repro.launch import roofline as JRL
from repro.train import grad_compression as JG
from repro.train import pipeline as JPL
from repro_torch import configs as C
from repro_torch.launch import analytic as A
from repro_torch.launch import roofline as RL
from repro_torch.models import registry
from repro_torch.train import grad_compression as G
from repro_torch.train import pipeline as PL

CELLS = [(arch, name) for arch in sorted(JC.ARCHS) for name in JC.SHAPES
         if JC.applicable(JC.get(arch), JC.SHAPES[name])[0]]


@pytest.mark.parametrize("arch, shape", CELLS)
def test_cell_cost_equals_reference(arch, shape):
    n = registry.param_count(C.get(arch))
    for shards in (32, 1):
        for bits in (0, 8):
            want = JA.cell_cost(JC.get(arch), JC.SHAPES[shape], n_params=n,
                                batch_shards=shards, weight_quant_bits=bits)
            got = A.cell_cost(C.get(arch), C.SHAPES[shape], n_params=n,
                              batch_shards=shards, weight_quant_bits=bits)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.hbm_bytes_total == want.hbm_bytes_total


RATES = [("t_compute", JRL.PEAK_FLOPS / RL.BF16_FLOP_PER_S),
         ("t_memory", JRL.HBM_BW / RL.HBM_BYTES_PER_S),
         ("t_collective", JRL.ICI_BW / RL.NVLINK_BYTES_PER_S)]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b",
                                  "mamba2-780m", "nemotron-4-340b"])
def test_roofline_terms(arch):
    """Per-device FLOPs, bytes, collective bytes and chips equal to the
    reference's for the production meshes and one card, FSDP x TP and
    sequence-parallel weight layouts; every time term the reference's
    times the ratio of the rates."""
    n = registry.param_count(C.get(arch))
    for shape in ("train_4k", "decode_32k", "prefill_32k"):
        if not JC.applicable(JC.get(arch), JC.SHAPES[shape])[0]:
            continue
        for pods, data, model in ((1, 16, 16), (2, 16, 16), (1, 1, 1)):
            for ws in (None, 1):
                kw = dict(pods=pods, data=data, model=model,
                          collective_bytes_per_device=3.5e9,
                          model_flops_global=1.25e18, weight_shards=ws)
                kind = JC.SHAPES[shape].kind
                want = JRL.Roofline.from_cost(JA.cell_cost(
                    JC.get(arch), JC.SHAPES[shape], n_params=n), kind, **kw)
                got = RL.Roofline.from_cost(A.cell_cost(
                    C.get(arch), C.SHAPES[shape], n_params=n), kind, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                for term, ratio in RATES:
                    assert getattr(got, term) == pytest.approx(
                        getattr(want, term) * ratio, rel=1e-12)
                row = got.row()
                assert row["bottleneck"] in ("compute", "memory",
                                             "collective")
                assert row["t_compute_s"] == got.t_compute


def test_h100_rates_are_the_data_sheet():
    """One home of the H100 figures: the kernels' bounds read them."""
    from repro_torch.kernels.fastgrnn_cell import ops
    assert (RL.BF16_FLOP_PER_S, RL.HBM_BYTES_PER_S, RL.NVLINK_BYTES_PER_S,
            RL.FP32_FLOP_PER_S, RL.FP32_OPS_PER_S) == (
        989e12, 3.35e12, 450e9, 67e12, 67e12 / 2)
    assert (ops.H100_HBM_BYTES_PER_S, ops.H100_FP32_FLOPS) == (3.35e12, 67e12)


def _hlo(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


def _programs():
    mesh = jax.make_mesh((8,), ("d",), axis_types=(jax.sharding.AxisType.Auto,))
    x = jnp.arange(8 * 64, dtype=jnp.float32).reshape(8, 64)

    def sm(body, out_spec=JP("d")):
        return jax.shard_map(body, mesh=mesh, in_specs=JP("d"),
                             out_specs=out_spec, check_vma=False)

    def loop(v):
        return jax.lax.fori_loop(
            0, 7, lambda i, a: jax.lax.psum(a, "d") * 0.5, v)
    return {
        "psum": _hlo(sm(lambda v: jax.lax.psum(v, "d")), x),
        "all_gather": _hlo(sm(lambda v: jax.lax.all_gather(
            v, "d", tiled=True), JP()), x),
        "psum_scatter": _hlo(sm(lambda v: jax.lax.psum_scatter(
            jnp.tile(v, (8, 1)), "d", scatter_dimension=0, tiled=True)), x),
        "fori_loop": _hlo(sm(loop), x),
    }


PROGRAMS = ("psum", "all_gather", "psum_scatter", "fori_loop")


@pytest.fixture(scope="module")
def programs():
    return _programs()


@pytest.mark.parametrize("name", PROGRAMS)
def test_parse_collectives_equals_reference(programs, name):
    text = programs[name]
    want = JRL.parse_collectives(text)
    got = RL.parse_collectives(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_bytes == want.total_bytes > 0
    assert RL._split_computations(text) == JRL._split_computations(text)
    if name == "fori_loop":
        # the loop body's all-reduce counted once per trip
        assert got.counts.get("all-reduce", 0) >= 7
        assert got.unknown_trip_whiles == 0


def test_parse_collectives_on_written_text():
    """A hand-written module: a tuple-typed all-reduce, a while with a
    constant-bound condition, a call."""
    text = """HloModule m
%body (p: (s32[], f32[4,8])) -> (s32[], f32[4,8]) {
  %p = (s32[], f32[4,8]) parameter(0)
  %x = f32[4,8]{1,0} get-tuple-element(%p), index=1
  %ar = f32[4,8]{1,0} all-reduce(%x), replica_groups={}, to_apply=%add
  ROOT %t = (s32[], f32[4,8]) tuple(%i, %ar)
}
%cond (p: (s32[], f32[4,8])) -> pred[] {
  %p = (s32[], f32[4,8]) parameter(0)
  %c = s32[] constant(5)
  %i = s32[] get-tuple-element(%p), index=0
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}
ENTRY %main (a: bf16[16,2]) -> bf16[16,2] {
  %a = bf16[16,2]{1,0} parameter(0)
  %ag = bf16[32,2]{1,0} all-gather(%a), dimensions={0}
  %w = (s32[], f32[4,8]) while(%init), condition=%cond, body=%body
  ROOT %cp = bf16[16,2]{1,0} collective-permute(%a), source_target_pairs={{0,1}}
}
"""
    got = RL.parse_collectives(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JRL.parse_collectives(text))
    assert got.counts == {"all-gather": 1, "all-reduce": 5,
                          "collective-permute": 1}
    for s in ("f32[4,8]{1,0}", "(s32[], bf16[3,5])", "pred[7]"):
        assert RL._shape_bytes(s) == JRL._shape_bytes(s)
    assert RL._trip_count(["%c = s32[] constant(12)"]) == JRL._trip_count(
        ["%c = s32[] constant(12)"]) == 12


@pytest.mark.parametrize("bits", [8, 16])
def test_ratios_equal(bits):
    assert G.compression_ratio(bits) == JG.compression_ratio(bits)
    for p, m in ((4, 6), (1, 1), (8, 32), (16, 3)):
        assert PL.bubble_fraction(p, m) == JPL.bubble_fraction(p, m)
