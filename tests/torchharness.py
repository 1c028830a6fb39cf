"""Shared helpers for the port's parity tests (not a test module).

Inputs are drawn with numpy so both packages get the same values (the
port cannot reproduce JAX's PRNG), and event logs of either package fold
into the same comparable form: per-stream ordered histories whose entries
carry every event field, with the logits as raw bytes, so comparison is
bit-exact.
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.invariants import assert_conservation
from repro_torch.serve.fleet import FleetConfig, FleetEngine
from repro_torch.serve.streaming import StreamingConfig


def np_params(seed, low_rank=True, H=16, d=3, C=6):
    """Float params at the paper's shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    m = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    p = ({"W1": m(H, 2), "W2": m(d, 2), "U1": m(H, 8), "U2": m(H, 8)}
         if low_rank else {"W": m(H, d), "U": m(H, H)})
    p.update(b_z=np.ones(H, np.float32), b_h=np.zeros(H, np.float32),
             zeta=np.float32(1.0), nu=np.float32(-4.0), head_w=m(H, C),
             head_b=np.zeros(C, np.float32))
    return p


def np_cell_params(seed, *, low_rank=True, alpha=False, H=16, d=3, C=6):
    """Float params at the paper's shapes with every leaf drawn (biases
    and head bias too, N(0, 0.3) matrices) so the LUTs see their whole
    range, and optionally the diagonal residual ``alpha``, with numpy."""
    rng = np.random.default_rng(seed)
    m = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    p = ({"W1": m(H, 2), "W2": m(d, 2), "U1": m(H, 8), "U2": m(H, 8)}
         if low_rank else {"W": m(H, d), "U": m(H, H)})
    if alpha:
        p["alpha"] = (0.1 + 0.05 * rng.standard_normal(H)).astype(np.float32)
    p.update(b_z=(1 + 0.3 * rng.standard_normal(H)).astype(np.float32),
             b_h=(0.3 * rng.standard_normal(H)).astype(np.float32),
             zeta=np.float32(1.0), nu=np.float32(-4.0), head_w=m(H, C),
             head_b=(0.1 * rng.standard_normal(C)).astype(np.float32))
    return p


def fold_log(events, log=None) -> dict:
    """Fold per-stream or columnar events of either package into
    ``{stream_id: [(kind, step, window_step, prediction, logits bytes,
    warm), ...]}`` (the entry layout of ``faultharness.collect_log``)."""
    log = {} if log is None else log
    for e in events:
        if e is None:
            continue
        if hasattr(e, "stream_ids"):
            for sid, fin, st, ws, p, lg, w in zip(
                    e.stream_ids, e.final, e.steps, e.window_steps,
                    e.predictions, e.logits, e.warm):
                log.setdefault(sid, []).append(
                    ("final" if fin else "window", int(st), int(ws),
                     int(p), np.asarray(lg, np.float32).tobytes(), bool(w)))
        else:
            log.setdefault(e.stream_id, []).append(
                (e.kind, int(e.step), int(e.window_step), int(e.prediction),
                 np.asarray(e.logits, np.float32).tobytes(), bool(e.warm)))
    return log


def port_crash_schedule(qp, streams: dict, *, shards: int,
                        slots_per_shard: int, injector,
                        snapshot_every: int = 64, window: int = 128,
                        batch_events: bool = False, mxu: bool = False,
                        obs=None) -> tuple[dict, dict]:
    """The port's twin of ``faultharness.run_crash_schedule`` on the CPU:
    every stream through a failover-enabled fleet under ``injector``, to
    completion.  Returns ``(event_log, stats)``."""
    fleet = FleetEngine(qp, FleetConfig(
        shards=shards,
        stream=StreamingConfig(max_slots=slots_per_shard, window=window,
                               batch_events=batch_events, device="cpu",
                               mxu=mxu),
        snapshot_every=snapshot_every), faults=injector, obs=obs)
    log: dict = {}
    for sid, w in streams.items():
        fleet.attach(sid, w, total_steps=len(w))
    fold_log(fleet.drain(), log)
    return log, fleet.stats()


def assert_counters_conserved(stats: dict) -> None:
    """The fleet counter-conservation invariant, through the port's own
    implementation."""
    assert_conservation(stats)


def reference_init(low_rank=True, seed=0) -> dict:
    """The reference's seed init, ``repro.core.fastgrnn.init_params`` on a
    threefry key, as NumPy.  Built under ``threefry_partitionable(False)``
    (ROADMAP C0): that is the init of the reference's committed fixtures
    (``tests/goldens/``, ``ANALYSIS_report.json``)."""
    import jax
    from repro.core import fastgrnn as jfg
    cfg = jfg.FastGRNNConfig(rank_w=2 if low_rank else None,
                             rank_u=8 if low_rank else None)
    with jax.threefry_partitionable(False):
        p = jfg.init_params(cfg, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}
