#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, window and LM paths on one CUDA
card.

    python3 chip_smoke.py [--parent TREE]

(``--parent``: also time the K1, K2, K5 and K6 of another checkout, e.g.
the parent commit unpacked by ``git archive``, beside this one's on the
same card.)

Phases (any failure exits non-zero; nothing is caught):

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 is switched off for matmuls and cuDNN (the window path's
   FP32 cell and classifier head run float32 matmuls).
2. build every kernel (``src/repro_torch/csrc/``: ``q15_step.cu`` K1,
   ``q15_step_dense.cu`` K2, ``fastgrnn_window.cu`` K3, ``lut_act.cu``
   K4, ``q15_matmul.cu`` K5, ``ssd_scan.cu`` K6) with nvcc, one process
   per source, started together (with ``--parent``, the other checkout's
   K1, K2, K5 and K6 beside them); fails unless ptxas reports a 0-byte
   stack frame for both fixed-width K1 instantiations and for K2's.
3. K1 vs plain on the card: S = 131,072 streams at paper width, low- and
   full-rank, deployed / calibrated / naive activation storage, about a
   third of the rows masked, 2 % of them driven into LUT saturation, 128
   chained steps.  The kernel must run its fixed-width code there and
   equal the plain torch step bitwise every step; the plain step on the
   card must equal the CPU plain step bitwise on 4,096 rows, and the
   scalar ``QRuntime`` must agree bitwise on 64 rows.  ``FastGRNNStep.plan``
   at S = 131,072 is printed for both ranks (fails unless the fixed code
   runs there with 0 bytes of local memory); then the K1 edge check, three
   chained steps each, bitwise: the runtime-width code at H = 12, d = 5 and
   at r_w = 3, r_u = 5, S = 1, S = 255 (naive storage) and S = 131,071 (a
   ragged last tile), h and out 4 bytes off a 16-byte boundary (the
   runtime-width code), all rows masked and none.
4. K2 vs plain on the card: the same inputs for the dense layout (low and
   full rank); K2 must equal ``qstep.step_dense`` bitwise every step and
   the plain dense step on the card the CPU one on 4,096 rows; K2 must be
   within 1e-6 of K1 after one step in deployed storage (the reference's
   bound for its dense layout) on 4,096 rows drawn like the reference's
   test; K2's runtime-width instantiation is checked at H = 12, d = 5.
   ``DenseStep.plan`` at S = 131,072 is printed for both ranks (fails
   unless the fixed code runs there with 0 bytes of local memory); then
   the K2 edge check, three chained steps each, bitwise against
   ``step_dense``: the runtime-width code at H = 12, d = 5, S = 1, 255 and
   131,071 (a ragged last tile), h and out 4 bytes off a 16-byte boundary
   (the runtime-width code), all rows masked and none.
   Then K4 vs ``core.lut.lut_eval`` bitwise for every fn x mode x
   {float32, bfloat16} on 2^24 values led by every edge (bucket edges,
   +-8 and their neighbours, +-0, +-inf, NaN), and on an unaligned view;
   and K3 vs ``qstep.window_scan`` bitwise on h and the whole trajectory
   at B = 131,072 windows x T = 128 (low and full rank, the plain scan on
   the card against the CPU's on 4,096 rows), its runtime-width code at
   H = 12, d = 5.  Then K5 vs ``kernels.q15_matmul.kernel.plain`` for
   int16 and int8 weights at every plan of its launcher (16-byte, 8-byte
   or scalar weight loads; one or two column tiles per warp; the launcher
   reports each case's, and all eight must run): the
   three LM heads at M = 1, their engine's slots, 9 and 64, every shape of
   the reference's ``tests/test_kernels.py``, (3, 1000, 1001), a ragged K
   and N, K = 0, K = 4,100, and weight views off 16-byte alignment:
   within 1e-5 x max|plain| of the plain
   version and within 2e-2 of the float32 oracle ``q15_matmul_ref``; its
   bfloat16 output bitwise equal to its float32 output rounded to
   bfloat16, and within 1e-5 x max|plain| plus one bfloat16 ulp of the
   plain version's bfloat16 output (a float32 sum in another order may
   round to the neighbouring bfloat16); leading dims (2, 5, K) through
   ``ops.q15_matmul``.  Then K6 vs ``kernels.ssd_scan.kernel.plain``
   through ``ops.ssd_scan`` on every shape of the reference's
   ``tests/test_kernels.py`` and on b = 2 x S = 1000 at mamba2-780m's and
   zamba2-1.2b's head layouts (chunk 256: four chunks, the last ragged),
   float32 and bfloat16 x / B / C: float32 y and state within rtol = atol
   = 1e-4 (the reference's bound); bfloat16 y within 1e-5 x max|y| plus
   one bfloat16 ulp of plain's y, the float32 state as in float32; the
   plain version on the card within 1e-4 of the CPU's on two heads.  Then
   K6 on the launcher's branches those shapes do not reach (K6_EDGES: one
   row, odd N x P, several P tiles, rows not 16-byte aligned), under the
   same bounds.
5. the single-engine main path: ``StreamingEngine.from_artifact`` on
   ``cuda`` with 131,072 slots over an artifact (seeded PTQ at
   ``fastgrnn_har`` width, round-tripped through ``.fgar``); 131,072 +
   1,024 synthetic-HAPT streams (some two windows long, some detached
   mid-window, the extra ones pending until slots free), drained.  K1
   launches must equal advancing ticks and every one must run K1's
   fixed-width code, sampled streams' events must be bitwise those of the
   CPU engine and of the scalar ``QRuntime``, and no hidden-state byte may
   go host-to-device.
6. a profiled steady window of that path (torch.profiler, host and
   device): the step kernel's device time and the device's busy share.
7. the window path (Table VI, Sec. VI-A) on the 3,399-window synthetic
   test split and the artifact's dequantized params: p2 the K1 engine
   (bitwise against the scalar ``QRuntime`` on 32 windows, logits and
   trajectories), p3 K3 through ``fastgrnn_window_kernel`` + the head
   (h and trajectory bitwise equal to ``window_scan`` on the same inputs),
   p1 ``core.fastgrnn.forward_window`` with ``kernels.lut_act.ops``'
   ``lut_sigmoid``/``lut_tanh`` (2 x 128 K4 launches, each output bitwise
   equal to ``lut_eval`` on the same tensor); p3 must agree with p2 on
   >= 99.9 % of the windows and p1 on >= 97 %; K3's trajectories must be
   within the reference's 2e-5 of the engine's on the first 100 windows,
   and the warm-up statistics of those windows come from both.  Then K3
   over the first window of each of phase 5's 131,072 streams (bitwise
   equal to ``window_scan``), >= 99.9 % of predictions equal to the K1
   engine's events; K3 launched twice in all.
8. the fleet main path on K2: ``FleetEngine.from_artifact`` with 4 shards
   x 32,768 slots, ``mxu=True``, the same streams, a live migration of 64
   streams and a decommission / recommission of one shard mid-run.  K2
   launches must equal the ticks that advanced (one device group), every
   one must run K2's fixed-width code, no
   h-state byte may go host-to-device on a steady tick, sampled streams'
   events must be bitwise those of a CPU fleet on ``step_dense``, and at
   least 99.9 % of the windows' predictions must equal the K1 engine's.
   Then a profiled steady window of the fleet, as in phase 6.
9. the same fleet on K1 (``mxu=False``): every stream's events must be
   bitwise those of the single engine (shard-count invariance on the
   card), and every K1 launch must run its fixed-width code.
10. failover: 4 shards x 4,096 slots on K2, snapshots every 16 ticks, one
    crash at each tick phase; the events must be bitwise those of the same
    run without crashes, and every K2 launch of both runs must run its
    fixed-width code.  The width is cut from 131,072 because every
    snapshot encodes each live stream in Python.
11. time every kernel and its plain version at its main path's shapes
    (K1/K2 at S = 131,072; K3 at B = 131,072 x T = 128; K4 over 2^26
    float32 and bfloat16 values): CUDA events over calls queued behind a
    sleep, after warm-up, over input sets larger than L2; the profiler's
    device time and the host's enqueue cost beside them; each kernel's
    bound (bytes over 3.35 TB/s or fp32 instructions over 33.5 T/s).
    K5 at each LM path's head and rows (Qwen2-1.5B's 8 x 1536 x 151,936
    in int16 and int8, and its prefill's M = 1; mamba2-780m's 8 x 1536 x
    50,280; zamba2-1.2b's 4 x 2048 x 32,000; weight sets past L2), with
    ``torch.mm`` of the bfloat16 x against the same weights
    converted to bfloat16 beforehand as the library yardstick of its bytes
    (not the same function: no integer weights, no scale); its
    operations count as bfloat16 tensor-core FLOP over 989 T/s.  With
    ``--parent`` the other checkout's K1, K2, K5 and K6 run in turns beside
    this checkout's (parent, kernel, then kernel, parent), each bound
    through this checkout's wrapper.  K6 at b = 1 x
    S = 1000 at mamba2-780m width in bfloat16 (four input sets of 31 MB),
    bound by the least operations of the scan at any chunk length (in
    bfloat16 every product on the tensor cores, the float32 operands as
    three bfloat16 parts; no library call computes the scan), its three
    phases' device times from the profiler; also at a one-chunk prompt
    (S = 256, bfloat16) and in float32 at S = 1000; each phase's grid,
    shared memory and blocks per
    SM at those shapes (P1 and P3 must have >= 132 blocks at S = 1000);
    with ``--parent`` the other checkout's K6 runs in turns beside each.
12. the LM serving path at full Qwen2-1.5B width (bfloat16 weights drawn
    from a CUDA generator seeded 0): ``quantize_tree`` on the card bitwise
    equal to the CPU's (int16 and int8) on the embedding table, layer 0's
    ``attn.q.w`` and ``mlp.w_out.w``; ``serve.engine.Engine`` on ``cuda``
    with 8 slots, ``max_len`` 512 and ``quant_bits`` 16 serving 24
    requests from seed 0 (prompts of 16-128 tokens, ``max_new`` 8-64):
    every request completes with exactly its budget of tokens, each in
    [0, vocab); K5 launches equal prefills + decode ticks; every head
    call's K5 output is held against the plain version on the same input
    (1e-5 x max|plain|, argmax equal wherever the plain logits' top-2
    margin exceeds twice the measured difference); tokens/s, prefill and
    decode-tick times and peak device memory are printed.  Then the same
    weights in float32 (TF32 off): a 4-slot cache, slots admitted at 32
    and 57 prompt tokens, 16 ``decode_step_slotted`` ticks with one slot
    inactive for the middle 4: the decode logits within 1e-3 of
    ``forward`` on each whole sequence, the inactive and empty slots'
    cache rows and ``pos`` bitwise unchanged.
13. mamba2-780m (``ssm``) at full width, the same way (bfloat16 weights
    from a CUDA generator seeded 0): 8 slots, ``max_len`` 1088, 24
    requests from seed 0 with prompts of 64-1000 tokens (one to four SSD
    chunks, ragged tails) and ``max_new`` 8-64; every mamba layer's
    prefill scan is K6: K6 launches = prefills x 48, K5 launches =
    prefills + decode ticks, and every K6 and K5 call is held against its
    plain version on the same inputs (phase 4's bounds); tokens/s, the
    engine's spans, peak memory, a profiled window of 10 decode ticks and
    one profiled prefill of a 1000-token prompt (host wall, the device's
    busy share, K6's device time by phase; fails if a phase is missing),
    with ``--parent`` timed again with the other checkout's K6 in the
    scan's place, in turns (parent, K6, K6, parent) x 5.
    Then the float32 slotted decode as in phase 12, over prompts of 57 and
    300 tokens (two chunks): within 1e-3 of ``forward``, the inactive and
    empty slots' SSM states, conv tails and ``pos`` bitwise unchanged.
14. zamba2-1.2b (``hybrid``: 38 mamba layers and one shared attention +
    GELU MLP block after every sixth) at full width: 4 slots, 8 requests
    with prompts of 64-600 tokens and ``max_new`` 8-32; the same
    completion checks, K6 launches = prefills x 38, every K6 and K5 call
    held against its plain version.  Each model is freed before the next.
15. L-S-Q on the card (the paper's pipeline, ``configs.fastgrnn_har``):
    ``core.pipeline.train_fastgrnn`` on ``cuda`` (eager autograd, TF32
    off) over the 7,352-window synthetic train split, seed 0, batch 64,
    lr 1e-3, IHT to s = 0.5 ramped over the first half of LSQ_EPOCHS
    epochs (cut from the paper's 100): epochs, steps, ms/step p50 and
    p99, first and last epoch loss, wall time and the 100-epoch
    extrapolation.  One loss gradient + Adam step from the trained
    params: the params it gives on the card within 1e-6 of those it gives
    on the CPU on every leaf.  ``default_deploy_pipeline(bits=15,
    sparsity=0.5)`` on the card and on the CPU: identical ``.fgar`` bytes,
    also through a round trip; 283 deployed parameters (566 B); sha256
    and size report.  Then phase 7's window path on the trained artifact
    (Table VI: K1 engine bitwise against the scalar ``QRuntime``, K3 >=
    99.9 %, FP32 + K4 >= 97 %; warm-up from K3 and the engine; K3's
    trajectory within 2e-5 of the engine's on window 0, as the reference
    holds it: on a trained model a few windows' LUT buckets flip between
    the two sums, as they do between the reference's own kernel and
    runtime), its K1,
    K3 and K4 launches counted apart from phase 7's, and the FP32 and Q15
    macro F1 and their agreement on the 3,399-window test split (F1 > 0.5
    and agreement > 95 %, the reference's bars in ``tests/test_system.py``).
16. the deploy path on the card (Sec. VI-B): (a) the reference's committed
    fixture ``tests/goldens/qvm_reference_s0.npz`` (read, never written):
    its 4,076-byte image round trips through ``DeployImage``, and the
    port's qvm traces, logits and predictions and the emitted int C
    (compiled on the host) equal the fixture's; (b)
    ``deploy.verify.run_parity`` on ``cuda`` over phase 15's trained
    artifact and the 3,399-window synthetic test split: every ``bitwise``
    entry true (the K1 engine's logits and per-step trajectories
    bit-identical to the emitted float C compiled with
    ``-ffp-contract=off``; the int C to the qvm, counters included; the
    static crosscheck), the C paths present, the float C and the scalar
    subset equal to the engine on every window, K1 launches = engine
    ticks, every one fixed-width; the qvm / int C / FP32 agreements, the
    image size, the AVR and MSP430 budgets and the section times printed;
    (c) the same checks on ``build_reference_artifact(seed=0)`` (a CPU
    ``torch.Generator`` draw) over 256 windows; (d) ``python -m
    repro_torch.compress --preset q15-deploy --emit-image`` on the card
    writes the bytes of ``build_image`` of the same artifact made on the
    CPU.  No C compiler, a failed check or a missing path fails the run.
17. OLMoE-1B-7B (``moe``: 16 layers, d_model 2048, 64 experts top-8,
    expert d_ff 1024, vocab 50,304) at full width, bfloat16 experts from
    a CUDA generator seeded 0: ``Engine(quant_bits=16)`` over 8 slots,
    ``max_len`` 512, 16 requests with prompts of 16-256 tokens (a prefill
    routes at capacity factor 1.25 and may drop tokens) and ``max_new``
    8-32; the same completion checks as phase 12, K5 launches = prefills
    + decode ticks, every head output within 1e-5 x max|plain| of the
    plain version; tokens/s, the engine's spans, peak memory and a
    profiled window of 10 decode ticks (as in phase 12).  Then the
    longest prompt prefilled twice through ``forward`` on the
    engine's weights: the logits bitwise equal (the MoE combine has no
    float atomic) and the dropped (token, expert) assignments counted
    (fails if none); one full-width layer's routing of 256 float32 tokens
    (``models.moe.route``: top-k experts and weights, slot table, kept
    assignments, inverse map) on the card bitwise the CPU's; and, the
    engine freed, the float32 slotted decode as in phase 12 within 1e-3
    of ``forward`` at the no-drop capacity factor, on the first
    MOE_DECODE_LAYERS of the 16 layers (float32 experts at 16 layers
    would take 25.8 GB).

The last lines are the ``{"kernels": [...]}`` record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
S_KERNEL = 131_072        # streams in the kernel-vs-plain phase
STEPS = 128               # chained steps per configuration
CPU_ROWS = 4_096          # rows re-run by the CPU plain step
SCALAR_ROWS = 64          # rows re-run by the scalar QRuntime
SLOTS = 131_072           # engine slots on the main path
EXTRA = 1_024             # streams that wait pending for a free slot
DETACH_TICK = 60          # mid-window detach point
SAMPLED = 256             # streams replayed on the CPU engine / fleet
SCALAR_STREAMS = 64       # of those, replayed by the scalar QRuntime
K1K2_ROWS = 4_096         # rows of the K2-vs-K1 one-step check
SHARDS = 4                # fleet shards on the fleet main path
SHARD_SLOTS = SLOTS // SHARDS
MIGRATE_TICK = 80         # fleet: live migration of MIGRATED streams
MIGRATED = 64
DECOMMISSION_TICK = 140   # fleet: shard 1 drained ...
RECOMMISSION_TICK = 160   # ... and returned to routing
MIN_AGREEMENT = 0.999     # K2 fleet windows whose prediction equals K1's
FO_SLOTS = 4_096          # failover: slots per shard (4 shards)
FO_SNAPSHOT_EVERY = 16
FO_CRASHES = ((7, "mid_dispatch", 1), (13, "pre_tick", 2),
              (20, "post_emit", 0))
PROFILE_WARM = 10         # untraced ticks before the profiled window
PROFILE_TICKS = 20        # ticks in the profiled steady window
TIMING_SETS = 8           # input sets cycled by the timing phase (> L2)
L2_BYTES = 50 * 2**20     # H100 L2 (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# fp32 instructions per second outside the tensor cores: the data sheet's
# 67 TFLOP/s counts an FMA as two operations, so one instruction (an FMA,
# an add or a multiply) issues at half that rate (132 SMs x 128 lanes x
# ~1.98 GHz).  The FastGRNN kernels' functions round between each multiply
# and add, so each is an instruction of its own there.
FP32_OPS_PER_S = 67e12 / 2
BF16_FLOP_PER_S = 989e12   # dense bfloat16 on the tensor cores (data sheet)
W_BATCH = 131_072         # window scan: windows per launch ...
W_STEPS = 128             # ... of this many samples (one paper window)
LUT_ELEMS = 1 << 24       # LUT kernel-vs-plain elements per configuration
LUT_TIMING_ELEMS = 1 << 26
LUT_FNS = ("sigmoid", "tanh", "silu", "gelu", "softplus")
TABLE6_SCALAR = 32        # Table VI: windows re-run by the scalar QRuntime
WARMUP_WINDOWS = 100      # Sec. VI-A: windows characterized (paper: 100)
MIN_K3_AGREEMENT = 0.999  # K3 windows whose prediction equals the K1 path's
MIN_FP32_AGREEMENT = 0.97  # FP32 + K4 LUT path vs the K1 path (reference)
LM_ARCH = "qwen2-1.5b"    # the LM path's model, at full width
LM_SLOTS = 8              # engine slots (the decode head's M)
LM_MAX_LEN = 512
LM_REQUESTS = 24          # three times the slots: admission, recycling, spills
LM_PROMPT = (16, 128)     # prompt tokens, inclusive range
LM_NEW = (8, 64)          # max_new, inclusive range
K5_REL = 1e-5             # K5 vs plain, relative to max |plain| (sum order)
K5_REF_REL = 2e-2         # K5 vs the float32 oracle (the reference's bound)
F32_DECODE_ATOL = 1e-3    # f32 slotted decode vs forward at full width
LM_PROFILE_TICKS = 10     # decode ticks in the LM path's profiled window
PREFILL_AB_ROUNDS = 5     # parent, K6, K6, parent prefills, with a parent
SSM_ARCH = "mamba2-780m"  # phase 13's model, at full width
SSM_PROMPT = (64, 1000)   # prompt tokens: one to four SSD chunks of 256
SSM_MAX_LEN = 1088        # the longest prompt + the largest budget
HYBRID_ARCH = "zamba2-1.2b"  # phase 14's model, at full width
HYBRID_SLOTS = 4
HYBRID_REQUESTS = 8
HYBRID_PROMPT = (64, 600)
HYBRID_NEW = (8, 32)
HYBRID_MAX_LEN = 640
K6_TOL = 1e-4             # K6 vs plain, float32 (the reference's rtol = atol)
K6_BF16_REL = 1e-5        # bfloat16 y: x max|y|, plus one bfloat16 ulp
K6_TIMING_S = 1000        # K6 timed at b = 1 x S tokens, mamba2-780m width
LSQ_EPOCHS = 20           # phase 15's training, cut from the paper's 100
ADAM_ATOL = 1e-6          # one Adam step on the card vs on the CPU
PAPER_NONZERO = 283       # deployed parameters at s = 0.5 (paper Table II)
BATCH_ADAM = 64           # windows in the card-vs-CPU Adam step
MIN_LSQ_F1 = 0.5          # the trained model's FP32 macro F1 ...
MIN_LSQ_AGREEMENT = 0.95  # ... and its Q15/FP32 agreement (the reference's)
GOLDEN = os.path.join(ROOT, "tests", "goldens", "qvm_reference_s0.npz")
GOLDEN_IMAGE_BYTES = 4_076  # the reference's committed Q15 image
DEPLOY_INIT_WINDOWS = 256  # phase 16 (c): windows on the seed-0 init artifact
MOE_ARCH = "olmoe-1b-7b"  # phase 17's model, at full width
MOE_REQUESTS = 16
MOE_PROMPT = (16, 256)    # prompt tokens: prefills that drop at cf 1.25
MOE_NEW = (8, 32)
MOE_ROUTING_TOKENS = 256  # tokens of the card-vs-CPU routing check
MOE_DECODE_LAYERS = 4     # the f32 decode-vs-forward check, cut from 16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def first_diff(a, b) -> str:
    import torch
    ne = (a.view(torch.int32) != b.view(torch.int32)).nonzero()
    r, c = (int(v) for v in ne[0])
    return (f"{ne.shape[0]} values differ, first at row {r} col {c}: "
            f"{float(a[r, c])!r} vs {float(b[r, c])!r}")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def environment(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    nvcc_ver = run([nvcc, "--version"]).splitlines()[-1]
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(f"card (nvidia-smi name, power.limit): {card}")
    print(f"nvcc {nvcc}: {nvcc_ver}")
    print(f"triton: {triton_ver}  ninja: {shutil.which('ninja')}")
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    return card


KERNELS = ("q15_step", "q15_step_dense", "fastgrnn_window", "lut_act",
           "q15_matmul", "ssd_scan")


def build(parent=None) -> None:
    """Every kernel, one nvcc each, started together (with ``parent``, the
    other checkout's K1, K2, K5 and K6 too); each one's build time and what
    ptxas reports of its registers, shared memory and spills.  Fails
    unless both fixed-width K1 instantiations and K2's have a 0-byte stack
    frame."""
    from repro_torch.kernels import _build
    if tuple(sorted(_build.kernel_names())) != tuple(sorted(KERNELS)):
        fail(f"kernel sources {_build.kernel_names()} != {sorted(KERNELS)}")
    t0 = time.perf_counter()
    procs = start_parent_builds(parent)
    built = _build.build_all()
    finish_parent_builds(parent, procs)
    wall = time.perf_counter() - t0
    for name, (lib, dt, log) in built.items():
        print(f"build: {lib.name} in {dt:.2f} s")
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "stack frame")):
                print(f"  {line.strip()}")
    print(f"build: {len(built)} kernels in {wall:.2f} s (parallel nvcc)")
    for name, label, kernel, n in (
            ("q15_step", "K1", K1_FIXED, 2),
            ("q15_step_dense", "K2", K2_FIXED, 1)):
        frames = fixed_frames(built[name][2], kernel)
        if built[name][1] and (len(frames) != n or any(frames.values())):
            fail(f"{label}'s fixed-width instantiations' stack frames "
                 f"{frames}, want {n} of 0 bytes")
        print(f"build: {label} fixed-width stack frames {frames} (bytes)")


K1_FIXED = "q15_step_kernel_fixed"         # the fixed-width entries' names
K2_FIXED = "q15_step_dense_kernel_fixed"


def k1_fixed_frames(log: str) -> dict:
    """:func:`fixed_frames` of K1's fixed-width kernels."""
    return fixed_frames(log, K1_FIXED)


def fixed_frames(log: str, kernel: str) -> dict:
    """{instantiation: stack frame bytes} of the fixed-width kernels named
    ``kernel`` in a ptxas -v log (the entry names are mangled:
    ILi16ELi3ELi2ELi8E is <16, 3, 2, 8>)."""
    import re
    frames, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and entry and re.search(rf"\d{kernel}I", entry):
            args = re.search(r"I((?:Li\d+E)+)E", entry)
            key = ",".join(re.findall(r"Li(\d+)E", args.group(1))) \
                if args else entry
            frames[key] = int(m.group(1))
            entry = None
    return frames


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def storage_modes(qp, windows):
    from repro_torch.core.qruntime import QRuntime, calibrate
    scales = calibrate(QRuntime(qp), windows)
    return {"deployed": {}, "calibrated": {"act_scales": scales},
            "naive": {"naive_acts": True}}


def kernel_vs_plain(torch, windows, dev) -> float:
    import numpy as np
    from repro_torch import weights
    from repro_torch.core.qruntime import QRuntime
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell import qstep
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step

    max_err = 0.0
    for low_rank in (True, False):
        qp = quantize_params(weights.random_params(SEED, low_rank=low_rank),
                             QuantConfig())
        for mode, kw in storage_modes(qp, windows[:5]).items():
            t0 = time.perf_counter()
            sw = qstep.StepWeights.from_quantized(qp, **kw)
            k_dev = make_fastgrnn_step(sw, device=dev)
            k_cpu = make_fastgrnn_step(sw, device="cpu")
            rt = QRuntime(qp, **kw)
            H, d = sw.hidden_dim, sw.input_dim
            g = torch.Generator(device=dev).manual_seed(SEED)
            h0 = 0.5 * torch.randn(S_KERNEL, H, generator=g, device=dev)
            h_k = h_p = h0
            h_c = h0[:CPU_ROWS].cpu()
            h_s = h0[:SCALAR_ROWS].cpu().numpy()
            for t in range(STEPS):
                # ~2% of rows get large inputs so the LUT saturation and
                # storage clip paths run too
                big = torch.rand(S_KERNEL, 1, generator=g, device=dev) < 0.02
                x = torch.randn(S_KERNEL, d, generator=g, device=dev) \
                    * torch.where(big, 200.0, 1.0)
                m = torch.rand(S_KERNEL, generator=g, device=dev) >= 1 / 3
                h_next = k_dev(h_k, x, m)
                if t == 0 and not k_dev.fixed_width(h_k, h_next):
                    fail(f"K1 did not run its fixed-width code at paper "
                         f"width ({mode}, low_rank={low_rank})")
                h_k = h_next
                h_p = k_dev.plain(h_p, x, m)
                if not bits_equal(h_k, h_p):
                    fail(f"kernel != plain ({mode}, low_rank={low_rank}, "
                         f"step {t}): {first_diff(h_k, h_p)}")
                max_err = max(max_err, float((h_k - h_p).abs().max()))
                xc, mc = x[:CPU_ROWS].cpu(), m[:CPU_ROWS].cpu()
                h_c = k_cpu(h_c, xc, mc)
                if not bits_equal(h_p[:CPU_ROWS].cpu(), h_c):
                    fail(f"plain cuda != plain cpu ({mode}, low_rank="
                         f"{low_rank}, step {t}): "
                         f"{first_diff(h_p[:CPU_ROWS].cpu(), h_c)}")
                xs, ms = xc[:SCALAR_ROWS].numpy(), mc[:SCALAR_ROWS].numpy()
                h_s = np.stack([rt.step(h_s[b], xs[b]) if ms[b] else h_s[b]
                                for b in range(SCALAR_ROWS)])
                if not bits_equal(torch.from_numpy(h_s), h_c[:SCALAR_ROWS]):
                    fail(f"QRuntime != plain cpu ({mode}, low_rank="
                         f"{low_rank}, step {t})")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            print(f"kernel==plain bitwise (fixed-width K1): "
                  f"{'low' if low_rank else 'full'}"
                  f"-rank {mode:10s} S={S_KERNEL} x {STEPS} steps "
                  f"(cpu plain {CPU_ROWS} rows, QRuntime {SCALAR_ROWS} rows) "
                  f"in {time.perf_counter() - t0:.1f} s")
    return max_err


def k1_step(dev, *, naive: bool = False, **shape):
    """A K1 wrapper for seeded Q15 weights at ``weights.random_params``'
    shape keywords (default: the paper's width, low rank)."""
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell import qstep
    from repro_torch.kernels.fastgrnn_cell.kernel import FastGRNNStep
    qp = quantize_params(weights.random_params(SEED, **shape), QuantConfig())
    return FastGRNNStep(qstep.StepWeights.from_quantized(
        qp, naive_acts=naive), dev)


def k1_plan(torch, dev) -> None:
    """``FastGRNNStep.plan`` at S = 131,072 (phase 3's and the main path's
    S) for both fixed-width instantiations; fails unless the fixed code
    runs there with no local memory."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for low_rank in (True, False):
        k = k1_step(dev, low_rank=low_rank)
        h = torch.empty(S_KERNEL, k.sw.hidden_dim, device=dev)
        pl = k.plan(S_KERNEL, h, torch.empty_like(h))
        print(f"K1 plan at S={S_KERNEL}, {'low' if low_rank else 'full'} "
              f"rank ({sms} SMs): " + ", ".join(f"{key} {v}" for key, v in
                                                pl.items()))
        if not pl["fixed"] or pl["local_bytes"]:
            fail(f"K1 at paper width: fixed {pl['fixed']}, local memory "
                 f"{pl['local_bytes']} B a thread; want the fixed-width code "
                 f"with none")


EDGE_STEPS = 3      # chained steps a K1 or K2 edge case


def k1_edges(torch, dev) -> None:
    """K1 bitwise against its plain version, for a few chained steps each,
    on the branches phase 3's shapes do not reach: the runtime-width code
    (H = 12, d = 5; r_w = 3, r_u = 5), S = 1, 255 (Q15 storage) and
    131,071 (a ragged last tile), h and out 4 bytes off a 16-byte boundary
    (the runtime-width code), all rows masked and none."""
    edge_steps(torch, dev, "K1", k1_step(dev), (
        ("H=12, d=5", k1_step(dev, hidden_dim=12, input_dim=5), 4_096,
         "third", False, False),
        ("r_w=3, r_u=5", k1_step(dev, rank_w=3, rank_u=5), 4_096, "third",
         False, False),
        ("S=1", None, 1, "third", False, True),
        ("S=255, naive storage", k1_step(dev, naive=True), 255, "third",
         False, True),
        (f"S={S_KERNEL - 1:,}", None, S_KERNEL - 1, "third", False, True),
        ("h, out 4 B off 16 B", None, 4_096, "third", True, False),
        ("all rows masked", None, 4_096, "all", False, True),
        ("no row masked", None, 4_096, "none", False, True)))


def edge_steps(torch, dev, name: str, paper, cases) -> None:
    """Each case (label, step or None for ``paper``, S, mask: "third" /
    "all" / "none", h and out 4 B off 16 B, fixed-width code wanted):
    ``EDGE_STEPS`` chained launches bitwise against the step's plain
    version, the first asserting which code ran."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    for label, k, n, masked, offset, want_fixed in cases:
        k = paper if k is None else k
        H, d = k.sw.hidden_dim, k.sw.input_dim

        def state():
            if not offset:
                return torch.empty(n, H, device=dev)
            return torch.empty(n * H + 1, device=dev)[1:].view(n, H)
        h = state()
        h.copy_(0.5 * torch.randn(n, H, generator=g, device=dev))
        for t in range(EDGE_STEPS):
            big = torch.rand(n, 1, generator=g, device=dev) < 0.02
            x = torch.randn(n, d, generator=g, device=dev) \
                * torch.where(big, 200.0, 1.0)
            m = {"third": torch.rand(n, generator=g, device=dev) >= 1 / 3,
                 "all": torch.zeros(n, dtype=torch.bool, device=dev),
                 "none": torch.ones(n, dtype=torch.bool, device=dev)}[masked]
            out = k._launch(h, x, m, state())
            if t == 0 and k.fixed_width(h, out) != want_fixed:
                fail(f"{name} edge {label}: fixed-width code "
                     f"{k.fixed_width(h, out)}, want {want_fixed}")
            want = k.plain(h, x, m)
            if not bits_equal(out, want):
                fail(f"{name} edge {label}, step {t}: {first_diff(out, want)}")
            h = out
        torch.cuda.synchronize()
        print(f"{name}==plain bitwise, edge {label}: S={n} x {EDGE_STEPS} "
              f"steps ({'fixed' if want_fixed else 'runtime'}-width code)")


class FixedCount:
    """A K1 or K2 wrapper's library seen through, to show which code its
    launches ran: each ``q15_step_launch`` (``q15_step_dense_launch``)
    first asks ``q15_step_plan`` (``q15_step_dense_plan``), the plan the
    launch itself makes, for its h and out, and counts those that run the
    fixed-width code.  It launches nothing of its own."""

    def __init__(self, lib):
        self._lib, self.fixed = lib, 0

    def _count(self, query, S, *args) -> None:
        import ctypes
        plan = (ctypes.c_int * 8)()
        if S and query(S, *args, plan) == 0:
            self.fixed += plan[0]

    def q15_step_launch(self, h, x, mask, out, S, H, D, low_rank, RW, RU,
                        *rest):
        self._count(self._lib.q15_step_plan, S, H, D, low_rank, RW, RU, h,
                    out)
        return self._lib.q15_step_launch(h, x, mask, out, S, H, D, low_rank,
                                         RW, RU, *rest)

    def q15_step_dense_launch(self, h, x, mask, out, S, H, D, *rest):
        self._count(self._lib.q15_step_dense_plan, S, H, D, h, out)
        return self._lib.q15_step_dense_launch(h, x, mask, out, S, H, D,
                                               *rest)

    def __getattr__(self, name):
        return getattr(self._lib, name)


# ---------------------------------------------------------------------------
# phase 4: K2 (dense layout) vs plain, and vs K1
# ---------------------------------------------------------------------------

def dense_vs_plain(torch, np, dev) -> float:
    """K2 against ``qstep.step_dense`` bitwise over chained steps at the
    main path's S, the plain dense step on the card against the CPU's, K2
    within 1e-6 of K1 after one step, and K2's runtime-width code path."""
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell import qstep
    from repro_torch.kernels.fastgrnn_cell.kernel import make_fastgrnn_step

    def model(low_rank, **kw):
        qp = quantize_params(weights.random_params(SEED, low_rank=low_rank,
                                                   **kw), QuantConfig())
        return qstep.StepWeights.from_quantized(qp)

    max_err = 0.0
    for low_rank in (True, False):
        t0 = time.perf_counter()
        sw = model(low_rank)
        k_dev = make_fastgrnn_step(sw, device=dev, mxu=True)
        k_cpu = make_fastgrnn_step(sw, device="cpu", mxu=True)
        H, d = sw.hidden_dim, sw.input_dim
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        h_k = h_p = 0.5 * torch.randn(S_KERNEL, H, generator=g, device=dev)
        h_c = h_k[:CPU_ROWS].cpu()
        for t in range(STEPS):
            big = torch.rand(S_KERNEL, 1, generator=g, device=dev) < 0.02
            x = torch.randn(S_KERNEL, d, generator=g, device=dev) \
                * torch.where(big, 200.0, 1.0)
            m = torch.rand(S_KERNEL, generator=g, device=dev) >= 1 / 3
            h_next = k_dev(h_k, x, m)
            if t == 0 and not k_dev.fixed_width(h_k, h_next):
                fail("K2 did not run its fixed-width code at paper width")
            h_k = h_next
            h_p = k_dev.plain(h_p, x, m)
            if not bits_equal(h_k, h_p):
                fail(f"K2 != plain dense (low_rank={low_rank}, step {t}): "
                     f"{first_diff(h_k, h_p)}")
            max_err = max(max_err, float((h_k - h_p).abs().max()))
            h_c = k_cpu(h_c, x[:CPU_ROWS].cpu(), m[:CPU_ROWS].cpu())
            if not bits_equal(h_p[:CPU_ROWS].cpu(), h_c):
                fail(f"plain dense cuda != cpu (low_rank={low_rank}, step "
                     f"{t}): {first_diff(h_p[:CPU_ROWS].cpu(), h_c)}")
        torch.cuda.synchronize()
        print(f"K2==plain dense bitwise: {'low' if low_rank else 'full'}-rank "
              f"S={S_KERNEL} x {STEPS} steps (cpu plain {CPU_ROWS} rows) in "
              f"{time.perf_counter() - t0:.1f} s")

        # one step against K1 in deployed storage, inputs drawn with numpy
        # like the reference's test of its dense layout
        rng = np.random.default_rng(SEED + 3)
        h = torch.from_numpy((rng.normal(size=(K1K2_ROWS, H)) * 0.4)
                             .astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(K1K2_ROWS, d))
                             .astype(np.float32)).to(dev)
        m = torch.ones(K1K2_ROWS, dtype=torch.bool, device=dev)
        k1 = make_fastgrnn_step(sw, device=dev)
        diff = float((k_dev(h, x, m) - k1(h, x, m)).abs().max())
        if not diff <= 1e-6:
            fail(f"K2 vs K1 after one step: max |diff| {diff} > 1e-6 "
                 f"(low_rank={low_rank})")
        print(f"K2 vs K1 one step, deployed storage, {K1K2_ROWS} rows: max "
              f"|diff| {diff:.3e} <= 1e-6")

    # the runtime-width instantiation (any width but the paper's)
    sw = model(True, hidden_dim=12, input_dim=5)
    k_dev = make_fastgrnn_step(sw, device=dev, mxu=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    h = 0.5 * torch.randn(CPU_ROWS, 12, generator=g, device=dev)
    x = torch.randn(CPU_ROWS, 5, generator=g, device=dev)
    m = torch.rand(CPU_ROWS, generator=g, device=dev) >= 1 / 3
    out = k_dev(h, x, m)
    if k_dev.fixed_width(h, out) or not bits_equal(out, k_dev.plain(h, x, m)):
        fail("K2 at H=12, d=5 (runtime-width code) != plain dense")
    print(f"K2==plain dense bitwise at H=12, d=5 (runtime-width code), "
          f"{CPU_ROWS} rows")
    return max_err


def k2_step(dev, **shape):
    """A K2 wrapper for seeded Q15 weights at ``weights.random_params``'
    shape keywords (default: the paper's width, low rank)."""
    from repro_torch import weights
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.kernels.fastgrnn_cell import qstep
    from repro_torch.kernels.fastgrnn_cell.kernel import DenseStep
    qp = quantize_params(weights.random_params(SEED, **shape), QuantConfig())
    return DenseStep(qstep.StepWeights.from_quantized(qp), dev)


def k2_plan(torch, dev) -> None:
    """``DenseStep.plan`` at S = 131,072 (phase 4's and the fleet's S) for
    the low- and full-rank weights; fails unless the fixed code runs there
    with no local memory."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for low_rank in (True, False):
        k = k2_step(dev, low_rank=low_rank)
        h = torch.empty(S_KERNEL, k.sw.hidden_dim, device=dev)
        pl = k.plan(S_KERNEL, h, torch.empty_like(h))
        print(f"K2 plan at S={S_KERNEL}, {'low' if low_rank else 'full'} "
              f"rank ({sms} SMs): " + ", ".join(f"{key} {v}" for key, v in
                                                pl.items()))
        if not pl["fixed"] or pl["local_bytes"]:
            fail(f"K2 at paper width: fixed {pl['fixed']}, local memory "
                 f"{pl['local_bytes']} B a thread; want the fixed-width code "
                 f"with none")


def k2_edges(torch, dev) -> None:
    """K2 bitwise against ``step_dense``, for a few chained steps each, on
    the branches phase 4's shapes do not reach: the runtime-width code
    (H = 12, d = 5), S = 1, 255 and 131,071 (a ragged last tile), h and out
    4 bytes off a 16-byte boundary (the runtime-width code), all rows
    masked and none."""
    edge_steps(torch, dev, "K2", k2_step(dev), (
        ("H=12, d=5", k2_step(dev, hidden_dim=12, input_dim=5), 4_096,
         "third", False, False),
        ("S=1", None, 1, "third", False, True),
        ("S=255", None, 255, "third", False, True),
        (f"S={S_KERNEL - 1:,}", None, S_KERNEL - 1, "third", False, True),
        ("h, out 4 B off 16 B", None, 4_096, "third", True, False),
        ("all rows masked", None, 4_096, "all", False, True),
        ("no row masked", None, 4_096, "none", False, True)))


# ---------------------------------------------------------------------------
# phase 4 (cont.): K4 (LUT activation) and K3 (window scan) vs plain
# ---------------------------------------------------------------------------

def lut_inputs(torch, np, n: int, dev):
    """n float32 values, N(0, 36), led by every edge the LUT defines: the
    257 bucket edges, +-8 and the floats next to them (float32 and
    bfloat16 neighbours), +-0, +-inf, NaN and huge values."""
    f32 = np.float32
    edges = -8.0 + np.arange(257, dtype=f32) / f32(16.0)
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e30, 7.96875,
               -7.96875, 8.0625, -8.0625]
    for v in (f32(8.0), f32(-8.0)):
        special += [np.nextafter(v, f32(0)), np.nextafter(v, f32(2 * v))]
    lead = np.concatenate([edges, np.nextafter(edges, f32(np.inf)),
                           np.nextafter(edges, f32(-np.inf)),
                           np.asarray(special, f32)]).astype(f32)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randn(n, generator=g, device=dev) * 6.0
    x[:len(lead)] = torch.from_numpy(lead).to(dev)
    return x


def lut_vs_plain(torch, np, dev) -> float:
    """K4 against ``core.lut.lut_eval`` bitwise for every fn x mode x
    {float32, bfloat16} on LUT_ELEMS values with every edge, and on an
    unaligned, odd-length view (the element-wise code path)."""
    from repro_torch.kernels.lut_act.kernel import LUTAct
    act = LUTAct()
    x32 = lut_inputs(torch, np, LUT_ELEMS + 1, dev)
    t0 = time.perf_counter()
    max_err = 0.0
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        for x in (x32[:LUT_ELEMS].to(dtype), x32[1:].to(dtype)[1:]):
            for fn in LUT_FNS:
                for mode in ("nearest", "lerp"):
                    y = act(x, fn, mode=mode)
                    want = act.plain(x, fn, mode=mode)
                    if y.dtype != dtype or not torch.equal(y.view(bits),
                                                           want.view(bits)):
                        bad = (y.view(bits) != want.view(bits)).nonzero()
                        i = int(bad[0, 0]) if len(bad) else 0
                        fail(f"K4 != lut_eval ({fn}, {mode}, {dtype}, "
                             f"{x.numel()} values): {len(bad)} differ, first "
                             f"x={float(x[i])!r}: {float(y[i])!r} vs "
                             f"{float(want[i])!r}")
                    d = (y.float() - want.float()).nan_to_num(0.0).abs()
                    max_err = max(max_err, float(d.max()))
    torch.cuda.synchronize()
    print(f"K4==lut_eval bitwise: {len(LUT_FNS)} fns x nearest/lerp x "
          f"float32/bfloat16 on {LUT_ELEMS} values (bucket edges, +-8 and "
          f"their neighbours, +-0, +-inf, NaN) and on an unaligned "
          f"{LUT_ELEMS - 1}-value view, in {time.perf_counter() - t0:.1f} s")
    return max_err


def window_vs_plain(torch, np, dev) -> float:
    """K3 against ``qstep.window_scan`` bitwise on h and the whole
    trajectory at W_BATCH x W_STEPS (low and full rank; 2 % of the inputs
    large enough to saturate the LUTs), the plain scan on the card against
    the CPU's on CPU_ROWS rows, and K3's runtime-width code at H=12, d=5."""
    from repro_torch import weights
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan

    def same(a, b):
        return bits_equal(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]))

    max_err = 0.0
    for low_rank in (True, False):
        t0 = time.perf_counter()
        params = weights.random_params(SEED, low_rank=low_rank)
        scan, cpu = WindowScan(params, dev), WindowScan(params, "cpu")
        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        xs = torch.randn(W_STEPS, W_BATCH, 3, generator=g, device=dev)
        big = torch.rand(W_STEPS, W_BATCH, 1, generator=g, device=dev) < 0.02
        xs = xs * torch.where(big, 200.0, 1.0)
        h, traj = scan(xs)
        if not scan.fixed_width(traj, h):
            fail("K3 did not run its fixed-width code at paper width")
        h_p, traj_p = scan.plain(xs)
        if not (same(traj, traj_p) and bits_equal(h, h_p)):
            fail(f"K3 != window_scan (low_rank={low_rank}): "
                 f"{first_diff(traj.reshape(-1, 16), traj_p.reshape(-1, 16))}")
        max_err = max(max_err, float((traj - traj_p).abs().max()))
        _, traj_c = cpu(xs[:, :CPU_ROWS].cpu().contiguous())
        if not same(traj_p[:, :CPU_ROWS].cpu(), traj_c):
            fail(f"plain window_scan cuda != cpu (low_rank={low_rank})")
        torch.cuda.synchronize()
        print(f"K3==window_scan bitwise: {'low' if low_rank else 'full'}-rank "
              f"B={W_BATCH} x T={W_STEPS}, h and the whole trajectory "
              f"(fixed-width code; cpu plain {CPU_ROWS} rows) in "
              f"{time.perf_counter() - t0:.1f} s")
    params = weights.random_params(SEED, low_rank=True, hidden_dim=12,
                                   input_dim=5)
    scan = WindowScan(params, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    xs = torch.randn(W_STEPS, CPU_ROWS, 5, generator=g, device=dev)
    h, traj = scan(xs)
    h_p, traj_p = scan.plain(xs)
    if scan.fixed_width(traj, h) or not (same(traj, traj_p)
                                         and bits_equal(h, h_p)):
        fail("K3 at H=12, d=5 (runtime-width code) != window_scan")
    print(f"K3==window_scan bitwise at H=12, d=5 (runtime-width code), "
          f"{CPU_ROWS} windows x T={W_STEPS}")
    return max_err


# ---------------------------------------------------------------------------
# phase 4 (cont.): K5 (quantized matmul) vs plain
# ---------------------------------------------------------------------------

def k5_error(torch, got, x, wq, scale, what: str) -> float:
    """Hold one float32 K5 output against the plain version and the
    float32 oracle on the same inputs; returns max |K5 - plain|."""
    from repro_torch.kernels.q15_matmul.kernel import plain
    from repro_torch.kernels.q15_matmul.ref import q15_matmul_ref
    want = plain(x, wq, scale)
    ref = q15_matmul_ref(x, wq, scale)
    err = float((got - want).abs().max())
    lim = K5_REL * float(want.abs().max())
    if not err <= lim:
        fail(f"K5 != plain ({what}): max |diff| {err:.3e} > {lim:.3e}")
    rel = float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    if not rel < K5_REF_REL:
        fail(f"K5 vs q15_matmul_ref ({what}): relative error {rel:.3e}")
    return err


def k5_heads():
    """(d_model, vocab) of the integer head of each LM path's model."""
    from repro_torch import configs
    return {a: (configs.get(a).d_model, configs.get(a).vocab_size)
            for a in (LM_ARCH, SSM_ARCH, HYBRID_ARCH)}


# every kernel K5's launcher can plan, by weight type: (how a lane loads a
# row of the weights, column tiles per warp)
K5_PLANS = {"int16": {("16-byte", 1), ("16-byte", 2), ("scalar", 1)},
            "int8": {("16-byte", 1), ("16-byte", 2), ("8-byte", 1),
                     ("8-byte", 2), ("scalar", 1)}}


def q15_vs_plain(torch, np, dev) -> None:
    """K5 against its plain version and the oracle, int16 and int8, float32
    and bfloat16 output, at every plan its launcher has: the three LM
    heads at the rows the engine gives them (prefill M = 1, zamba2's M = 4,
    the 8 slots) and past one tile of rows (M = 9, 64); the reference
    test's shapes; a ragged K and N, K = 0, a K past 2,048; weight views
    whose data pointer is off 16-byte alignment; leading dims through
    ``ops.q15_matmul``.  Fails unless the cases ran every plan of
    ``K5_PLANS``.  (The kernels line reports the LM path's own largest
    |K5 - plain|.)"""
    from repro_torch.kernels.q15_matmul import ops
    from repro_torch.kernels.q15_matmul.kernel import Q15Matmul, plain
    mm = Q15Matmul()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    scale = ops.as_scale(0.0021, dev)
    heads = k5_heads()
    (qk, qn), (mk, mn), (zk, zn) = (heads[a] for a in (LM_ARCH, SSM_ARCH,
                                                        HYBRID_ARCH))
    reached = {"int16": set(), "int8": set()}
    errs = {"head": 0.0}

    def check(m, k, n, dtype, off_bytes=0):
        hi = 30000 if dtype == torch.int16 else 120
        name = str(dtype)[6:]
        off = off_bytes * 8 // torch.iinfo(dtype).bits
        x = torch.randn(m, k, generator=g, device=dev)
        buf = torch.randint(-hi, hi, (k * n + off,), generator=g,
                            device=dev).to(dtype)
        wq = buf[off:].view(k, n)
        what = f"{name} {m}x{k}x{n}" + (
            f", weights {off_bytes} B off 16-byte alignment" if off else "")
        reached[name].add(mm.plan(wq, m))
        got = mm(x, wq, scale)
        err = k5_error(torch, got, x, wq, scale, what)
        if (k, n) in ((qk, qn), (mk, mn), (zk, zn)) and not off:
            errs["head"] = max(errs["head"], err)
        bf = mm(x, wq, scale, out_dtype=torch.bfloat16)
        if not torch.equal(bf.view(torch.int16),
                           got.to(torch.bfloat16).view(torch.int16)):
            fail(f"K5 bfloat16 output != its float32 output rounded "
                 f"({what})")
        # the float32 bound plus one bfloat16 rounding step of plain's
        pb = plain(x, wq, scale, out_dtype=torch.bfloat16).float()
        ulp = torch.ldexp(torch.ones_like(pb), torch.frexp(pb)[1] - 8)
        lim = K5_REL * float(plain(x, wq, scale).abs().max()) + ulp
        if not bool(((bf.float() - pb).abs() <= lim).all()):
            fail(f"K5 bfloat16 output off the plain version's by more "
                 f"than {K5_REL} x max|plain| + one bfloat16 ulp "
                 f"({what})")

    shapes = [(LM_SLOTS, qk, qn), (1, qk, qn), (64, qk, qn),
              (LM_SLOTS, mk, mn), (1, mk, mn), (9, mk, mn),
              (HYBRID_SLOTS, zk, zn), (1, zk, zn), (64, zk, zn),
              (8, 32, 16), (64, 96, 130), (200, 256, 128), (1, 128, 256),
              (3, 1000, 1001), (9, 40, 72), (4, 4100, 96), (2, 0, 64)]
    # (M, K, N, bytes off 16-byte alignment: int16, int8)
    views = [(LM_SLOTS, mk, mn, (2, 1)), (HYBRID_SLOTS, zk, zn, (8, 8)),
             (9, 40, 72, (6, 8))]
    n_cases = 0
    for dtype in (torch.int16, torch.int8):
        for m, k, n in shapes:
            check(m, k, n, dtype)
        for m, k, n, offs in views:
            check(m, k, n, dtype, offs[dtype == torch.int8])
        n_cases += len(shapes) + len(views)
    for name, want in K5_PLANS.items():
        if reached[name] != want:
            fail(f"K5 {name}: plans reached {sorted(reached[name])}, want "
                 f"{sorted(want)}")
    for dtype, hi in ((torch.int16, 30000), (torch.int8, 120)):
        x = torch.randn(2, 5, 64, generator=g, device=dev)
        wq = torch.randint(-hi, hi, (64, 32), generator=g,
                           device=dev).to(dtype)
        out = ops.q15_matmul(x, wq, 0.0021)
        if out.shape != (2, 5, 32):
            fail(f"ops.q15_matmul lead dims: shape {tuple(out.shape)}")
        k5_error(torch, out.reshape(10, 32), x.reshape(10, 64), wq, scale,
                 f"{str(dtype)[6:]} (2, 5, 64) through ops")
    torch.cuda.synchronize()
    print(f"K5 vs plain: int16 and int8, float32 and bfloat16 output, "
          f"{n_cases} cases: the heads {qk}x{qn} (M 1, "
          f"{LM_SLOTS}, 64), {mk}x{mn} (M 1, {LM_SLOTS}, 9) and {zk}x{zn} "
          f"(M 1, {HYBRID_SLOTS}, 64), the reference test's four, "
          f"3x1000x1001, 9x40x72, 4x4100x96, 2x0x64, {len(views)} weight "
          f"views off 16-byte alignment each; plans reached (load, tiles "
          f"per warp): int16 {sorted(reached['int16'])}, int8 "
          f"{sorted(reached['int8'])}; within {K5_REL} x max|plain| "
          f"(largest |diff| at the heads {errs['head']:.3e}) and "
          f"{K5_REF_REL} of q15_matmul_ref; bfloat16 output = float32 "
          f"output rounded, within that bound + one bfloat16 ulp of "
          f"plain's; lead dims (2, 5, 64) through ops; in "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 5: the single-engine main path
# ---------------------------------------------------------------------------

class Feeds:
    """Deterministic per-stream samples: a pool of synthetic-HAPT windows
    plus a bank of small noise, both made once from the seed."""

    def __init__(self, np, hapt):
        self.pool = hapt.generate_synthetic("test", SEED, n=4096).windows
        rng = np.random.default_rng(SEED)
        self.noise = (0.02 * rng.standard_normal((4093, 256, 3))).astype(
            np.float32)
        self.np = np

    def kind(self, i: int) -> str:
        if i % 16 == 0:
            return "two"
        if i % 16 == 1 and i < SLOTS:
            return "detach"
        return "one"

    def samples(self, i: int):
        np = self.np
        P = len(self.pool)
        n = self.noise[(i * 7919) % len(self.noise)]
        if self.kind(i) == "two":
            return np.concatenate([self.pool[i % P],
                                   self.pool[(i + 1) % P]]) + n
        return self.pool[i % P] + n[:128]


def drive(engine, feeds, ids):
    """Attach ``ids``, tick to the detach point, detach the mid-window
    streams, drain.  Returns (events, per-tick seconds, wall seconds,
    steady-tick ledger delta)."""
    import torch
    for i in ids:
        kind = feeds.kind(i)
        total = None if kind == "detach" else (256 if kind == "two" else 128)
        engine.attach(f"s{i}", feeds.samples(i), total_steps=total)
    events, ticks = [], []
    steady = None
    t_start = time.perf_counter()
    for t in range(DETACH_TICK):
        before = dict(engine.kernel.transfers.snapshot())
        t0 = time.perf_counter()
        events += engine.step()
        ticks.append(time.perf_counter() - t0)
        if t == 10:   # a steady tick: nothing admitted or emitted
            after = engine.kernel.transfers.snapshot()
            steady = {k: after[k] - before[k] for k in after}
    for i in ids:
        if feeds.kind(i) == "detach":
            events.append(engine.detach(f"s{i}"))
    while engine._any_buffered():
        n = engine.stats()["ticks"]
        t0 = time.perf_counter()
        events += engine.step()
        ticks.append(time.perf_counter() - t0)
        if engine.stats()["ticks"] == n:
            fail("a tick advanced no stream while samples were buffered")
    if engine.kernel.device.type == "cuda":
        torch.cuda.synchronize()
    return events, ticks, time.perf_counter() - t_start, steady


def per_stream(events, wanted) -> dict:
    """{stream_id: [(kind, step, window_step, prediction, warm, logits
    bytes)]} for the wanted ids, from per-stream and columnar events."""
    out = {sid: [] for sid in wanted}
    for e in events:
        if e is None:
            continue
        if hasattr(e, "stream_ids"):
            for j, sid in enumerate(e.stream_ids):
                if sid in out:
                    out[sid].append(("final" if e.final[j] else "window",
                                     int(e.steps[j]), int(e.window_steps[j]),
                                     int(e.predictions[j]), bool(e.warm[j]),
                                     e.logits[j].tobytes()))
        elif e.stream_id in out:
            out[e.stream_id].append((e.kind, e.step, e.window_step,
                                     e.prediction, e.warm,
                                     e.logits.tobytes()))
    return out


def main_path(torch, np, dev):
    from repro_torch import weights
    from repro_torch.compress import ModelArtifact
    from repro_torch.core.qruntime import QRuntime
    from repro_torch.core.quantization import QuantConfig, quantize_params
    from repro_torch.data import hapt
    from repro_torch.obs import Observability, Tracer
    from repro_torch.serve.streaming import StreamingConfig, StreamingEngine

    params = weights.random_params(SEED)
    art = ModelArtifact.from_params(params, {"source": "chip_smoke seed 0"})
    art = art.replace(qp=quantize_params(params, QuantConfig()))
    blob = art.to_bytes()
    art = ModelArtifact.from_bytes(blob)
    if art.to_bytes() != blob:
        fail(".fgar round trip changed the bytes")
    feeds = Feeds(np, hapt)
    ids = list(range(SLOTS + EXTRA))

    # the host-clock span tracer breaks each tick into its phases
    obs = Observability(tracer=Tracer(capacity=1024))
    eng = StreamingEngine.from_artifact(
        art, StreamingConfig(max_slots=SLOTS, batch_events=True, device=dev),
        obs=obs)
    step_kernel = eng.kernel.kernel
    lib = step_kernel._lib
    step_kernel._lib = counted = FixedCount(lib)
    t0 = time.perf_counter()
    step_kernel.launches = 0            # count the main path's run only
    events, ticks, wall, steady = drive(eng, feeds, ids)
    launches = step_kernel.launches
    setup = time.perf_counter() - t0 - wall
    step_kernel._lib = lib
    st = eng.stats()
    if launches != st["ticks"]:
        fail(f"kernel launches {launches} != advancing ticks {st['ticks']}")
    if counted.fixed != launches:
        fail(f"K1 ran its fixed-width code on {counted.fixed} of {launches} "
             f"main-path launches")
    expect_steps = sum(DETACH_TICK if feeds.kind(i) == "detach" else
                       (256 if feeds.kind(i) == "two" else 128) for i in ids)
    if st["stream_steps"] != expect_steps:
        fail(f"stream steps {st['stream_steps']} != {expect_steps}")
    tr = st["transfers"]
    if tr["h_h2d_bytes"] != 0:
        fail(f"h-state h2d bytes {tr['h_h2d_bytes']} != 0")
    if steady["h_h2d_bytes"] or steady["h_d2h_bytes"]:
        fail(f"steady tick moved h bytes: {steady}")

    # sampled streams: the CPU engine and the scalar runtime
    sample = sample_ids()
    cpu = StreamingEngine.from_artifact(
        art, StreamingConfig(max_slots=len(sample), device="cpu",
                             batch_events=True))
    cpu_events = drive(cpu, feeds, sample)[0]
    wanted = [f"s{i}" for i in sample]
    got, ref = per_stream(events, wanted), per_stream(cpu_events, wanted)
    for sid in wanted:
        if not got[sid] or got[sid] != ref[sid]:
            fail(f"stream {sid}: cuda events {got[sid][:1]} != "
                 f"cpu events {ref[sid][:1]}")
    rt = QRuntime.from_artifact(art)
    for i in sample[:SCALAR_STREAMS]:
        x = feeds.samples(i)
        kind = feeds.kind(i)
        wins = ([x[:128], x[128:]] if kind == "two" else
                [x[:DETACH_TICK]] if kind == "detach" else [x])
        logits = [rt.run_window(w).tobytes() for w in wins]
        if [e[5] for e in got[f"s{i}"]] != logits:
            fail(f"stream s{i}: logits differ from the scalar QRuntime")

    rate = st["stream_steps"] / wall
    print(f"main path: {len(ids)} streams ({EXTRA} pending at attach) over "
          f"{SLOTS} slots, {st['ticks']} ticks, {st['stream_steps']} "
          f"stream-steps in {wall:.3f} s = {rate:,.0f} stream-steps/s; "
          f"{len(ticks)} step() calls: {tick_stats(np, ticks)}; "
          f"set-up (attach) {setup:.1f} s")
    print_host("main path", tr, steady, obs.tracer)
    print(f"main path: {len(sample)} sampled streams bitwise equal to the "
          f"CPU engine, {SCALAR_STREAMS} to the scalar QRuntime; K1's "
          f"fixed-width code on {counted.fixed} of {launches} launches")
    print("kernels: " + json.dumps([{"name": "q15_step", "launches": launches,
                                     "bitwise": True}]))
    return launches, eng, feeds, art, events


# ---------------------------------------------------------------------------
# phase 7: the window path (Table VI three-path agreement, warm-up, scale)
# ---------------------------------------------------------------------------

def window_path(torch, np, dev, art, label: str = "",
                held: int = WARMUP_WINDOWS) -> dict:
    """Table VI on the paper's 3,399-window synthetic test split, the
    artifact's dequantized params for the integer and kernel paths:
    p2 the K1 ``StreamingEngine`` (bitwise against the scalar ``QRuntime``
    on TABLE6_SCALAR windows, logits and trajectories), p3 K3 through
    ``fastgrnn_window_kernel`` with the head on its final h (h and the
    whole trajectory bitwise against the plain ``window_scan`` on the same
    inputs), p1 ``core.fastgrnn.forward_window`` on the float params with
    K4's ``lut_sigmoid``/``lut_tanh`` (each output bitwise against
    ``lut_eval`` on the same tensor).  Then the Sec. VI-A warm-up of the
    first WARMUP_WINDOWS windows from K3's and from the engine's
    trajectories, the first ``held`` of them held to the reference's 2e-5
    against the engine's.  ``label`` leads every printed line.  Returns p1's K4
    launches (``k4``), the engine's K1 launches (``k1``), the test split
    and p2's predictions."""
    from repro_torch.core import fastgrnn as fg
    from repro_torch.core import warmup
    from repro_torch.core.qruntime import QRuntime
    from repro_torch.data import hapt
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan
    from repro_torch.kernels.fastgrnn_cell.ops import fastgrnn_window_kernel
    from repro_torch.kernels.lut_act import ops as lut_ops
    from repro_torch.kernels.lut_act.kernel import LUTAct
    from repro_torch.serve.streaming import StreamingConfig, StreamingEngine

    split = hapt.generate_synthetic("test", SEED)
    windows = split.windows
    N, T, _ = windows.shape
    ids = [f"w{i}" for i in range(N)]
    t0 = time.perf_counter()
    eng = StreamingEngine.from_artifact(art, StreamingConfig(
        max_slots=N, batch_events=True, device=dev))
    eng.kernel.kernel.launches = 0      # count p2's run only
    for i, sid in enumerate(ids):
        eng.attach(sid, windows[i], total_steps=T,
                   record_trajectory=i < WARMUP_WINDOWS)
    ev = per_stream(eng.drain(), ids)
    if any(not ev[sid] or ev[sid][-1][2] != T for sid in ids):
        fail("Table VI: a window closed without its 128-sample event")
    p2 = np.array([ev[sid][-1][3] for sid in ids])
    t_p2 = time.perf_counter() - t0
    k1_launches = eng.kernel.kernel.launches
    rt = QRuntime.from_artifact(art)
    for i in range(TABLE6_SCALAR):
        logits, traj = rt.run_window(windows[i], return_trajectory=True)
        if ev[ids[i]][-1][5] != logits.tobytes() or \
                eng.trajectory(ids[i]).tobytes() != traj.tobytes():
            fail(f"Table VI: K1 engine != scalar QRuntime on window {i}")

    deq = art.require_qp().dequantize()
    xs = torch.from_numpy(np.ascontiguousarray(windows.transpose(1, 0, 2)))
    xs = xs.to(dev)
    t0 = time.perf_counter()
    h, traj = fastgrnn_window_kernel(deq, xs, device=dev)
    head_w, head_b = deq["head_w"].to(dev), deq["head_b"].to(dev)
    p3 = (h @ head_w + head_b).argmax(-1).cpu().numpy()
    t_p3 = time.perf_counter() - t0
    H = h.shape[1]
    h_p, traj_p = WindowScan(deq, dev).plain(xs)
    if not bits_equal(h, h_p):
        fail(f"Table VI p3: K3's h != window_scan's: {first_diff(h, h_p)}")
    if not bits_equal(traj.reshape(-1, H), traj_p.reshape(-1, H)):
        fail(f"Table VI p3: K3's trajectory != window_scan's: "
             f"{first_diff(traj.reshape(-1, H), traj_p.reshape(-1, H))}")
    del h_p, traj_p

    act = LUTAct()
    checked = []

    def k4_checked(op, fn):
        def f(v):
            y = op(v)
            want = act.plain(v, fn)
            if not bits_equal(y, want):
                fail(f"Table VI p1: K4 {fn} != lut_eval on step "
                     f"{len(checked) // 2}: {first_diff(y, want)}")
            checked.append(fn)
            return y
        return f

    fp = {k: torch.from_numpy(v).to(dev) for k, v in art.params.items()}
    LUTAct.launches = 0                 # count p1's run only
    t0 = time.perf_counter()
    logits1 = fg.forward_window(
        fp, xs, sigma=k4_checked(lut_ops.lut_sigmoid, "sigmoid"),
        tanh=k4_checked(lut_ops.lut_tanh, "tanh"))
    p1 = logits1.argmax(-1).cpu().numpy()
    t_p1 = time.perf_counter() - t0
    k4_launches = LUTAct.launches
    if k4_launches != 2 * T or len(checked) != 2 * T:
        fail(f"p1 launched K4 {k4_launches} times and checked "
             f"{len(checked)} outputs, want 2 x {T}")

    a32, a12, a13 = (float(np.mean(p3 == p2)), float(np.mean(p1 == p2)),
                     float(np.mean(p1 == p3)))
    print(f"{label}Table VI ({N} synthetic test windows, seed {SEED}): p3 "
          f"K3 vs p2 K1 engine {a32:.4%} ({int(np.sum(p3 == p2))}/{N}); "
          f"p1 FP32+K4 vs p2 {a12:.4%}; p1 vs p3 {a13:.4%}; K1 engine "
          f"bitwise equal to the scalar QRuntime on {TABLE6_SCALAR} windows "
          f"(logits and "
          f"trajectories); K3's h and trajectory bitwise equal to "
          f"window_scan's, each of p1's {len(checked)} K4 outputs bitwise "
          f"equal to lut_eval's; wall p2 {t_p2:.2f} s, p3 {t_p3 * 1e3:.1f} "
          f"ms, p1 {t_p1 * 1e3:.1f} ms with its checks")
    if a32 < MIN_K3_AGREEMENT:
        fail(f"K3 vs K1 agreement {a32:.4%} < {MIN_K3_AGREEMENT:.1%}")
    if a12 < MIN_FP32_AGREEMENT:
        fail(f"FP32+K4 vs K1 agreement {a12:.4%} < {MIN_FP32_AGREEMENT:.0%}")

    n = WARMUP_WINDOWS
    k_traj = traj[:, :n].cpu().numpy()
    e_traj = np.stack([eng.trajectory(ids[i]) for i in range(n)], axis=1)
    err = np.abs(k_traj - e_traj).max(axis=(0, 2))
    print(f"{label}K3 trajectory vs the K1 engine's, first {n} windows: "
          f"max |diff| {float(err.max()):.3e} ({int(np.sum(err > 2e-5))} "
          f"windows over the reference's 2e-5: "
          f"{np.nonzero(err > 2e-5)[0].tolist()}); the first {held} held")
    if err[:held].max() > 2e-5:
        fail(f"K3 trajectory vs the K1 engine's on the first {held} "
             f"windows: {float(err[:held].max()):.3e} > 2e-5 (the "
             f"reference's bound, tests/test_qruntime.py)")
    stats = {}
    for name, tr in (("K3", k_traj), ("K1 engine", e_traj)):
        logits = tr @ deq["head_w"].numpy() + deq["head_b"].numpy()
        preds = logits.argmax(-1).T                          # (n, T)
        stats[name] = (warmup.characterize(preds),
                       [warmup.stabilization_step(p) for p in preds])
        print(f"{label}warm-up (Sec. VI-A) from {name} trajectories: "
              f"{stats[name][0].row()}")
    differ = sum(a != b for a, b in zip(stats["K3"][1],
                                        stats["K1 engine"][1]))
    print(f"{label}warm-up: t* differs between K3 and the K1 engine on "
          f"{differ} of {n} windows")
    return {"k4": k4_launches, "k1": k1_launches, "split": split, "p2": p2}


def window_at_scale(torch, np, dev, art, feeds, single) -> None:
    """K3 over the first 128-sample window of each of the main path's
    SLOTS streams, h and trajectory bitwise against the plain
    ``window_scan``: predictions against the K1 engine's event at sample
    128 of each stream that was not detached before it."""
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan
    from repro_torch.kernels.fastgrnn_cell.ops import fastgrnn_window_kernel
    t0 = time.perf_counter()
    x = np.empty((W_STEPS, SLOTS, 3), np.float32)
    for i in range(SLOTS):
        x[:, i] = feeds.samples(i)[:W_STEPS]
    setup = time.perf_counter() - t0
    deq = art.require_qp().dequantize()
    t0 = time.perf_counter()
    h, traj = fastgrnn_window_kernel(deq, x, device=dev)
    pred = (h @ deq["head_w"].to(dev) + deq["head_b"].to(dev)).argmax(-1)
    pred = pred.cpu().numpy()
    wall = time.perf_counter() - t0
    h_p, traj_p = WindowScan(deq, dev).plain(torch.from_numpy(x).to(dev))
    H = h.shape[1]
    if not (bits_equal(h, h_p) and bits_equal(traj.reshape(-1, H),
                                              traj_p.reshape(-1, H))):
        fail(f"K3 at scale != window_scan: "
             f"{first_diff(traj.reshape(-1, H), traj_p.reshape(-1, H))}")
    del traj, h_p, traj_p
    n = same = 0
    for i in range(SLOTS):
        first = [e for e in single[f"s{i}"] if e[1] == W_STEPS]
        if first:
            n += 1
            same += first[0][3] == pred[i]
    share = same / n
    print(f"K3 at scale: {SLOTS} streams' first windows in one launch, "
          f"{wall * 1e3:.1f} ms wall with h2d and head (inputs built in "
          f"{setup:.1f} s), h and trajectory bitwise equal to window_scan's; "
          f"{same} of {n} predictions ({share:.4%}) equal the "
          f"K1 engine's events at sample {W_STEPS} "
          f"({SLOTS - n} streams detached before it)")
    if share < MIN_K3_AGREEMENT:
        fail(f"K3 at scale: agreement {share:.4%} < {MIN_K3_AGREEMENT:.1%}")


# ---------------------------------------------------------------------------
# trace helpers (torch.profiler)
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """The trace's device-side events: kernels, copies and memsets."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the events' device intervals, in us."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def kernel_device_us(prof, name: str):
    """(launches, mean device us) of kernel ``name`` from the trace's
    ``key_averages``, or None when the trace holds no such kernel."""
    rows = [e for e in prof.key_averages() if name in e.key]
    n = sum(e.count for e in rows)
    t = sum(getattr(e, "device_time_total", 0.0) for e in rows)
    return (n, t / n) if n and t > 0 else None


# ---------------------------------------------------------------------------
# phase 6: a profiled steady window of the single-engine main path
# ---------------------------------------------------------------------------

def profiled_window(torch, eng, feeds, kernel: str = "q15_step_kernel",
                    label: str = "profiled window") -> dict:
    """Refill the drained engine (or fleet) with one-window streams, step
    ``PROFILE_WARM`` ticks, then trace ``PROFILE_TICKS`` steady ticks
    (nothing admitted or emitted) with torch.profiler (host and device).
    The device busy share is the union of the trace's device intervals over
    the window's host wall time; the profiler's own host overhead lengthens
    that wall time, so the idle share read here is an upper estimate."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(SLOTS):
        eng.attach(f"p{i}", feeds.samples(i)[:128], total_steps=128)
    for _ in range(PROFILE_WARM):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = device_events(prof)
    kern = kernel_device_us(prof, kernel)
    if not evs or kern is None:
        fail(f"{label}: the trace holds no device event of {kernel}")
    busy = busy_us(evs)
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"{label} ({PROFILE_TICKS} steady ticks, {SLOTS} active "
          f"slots): host wall {wall_us:.1f} us ({wall_us / PROFILE_TICKS:.1f}"
          f" us per tick), device busy {busy:.1f} us = {busy / wall_us:.2%}, "
          f"idle {1 - busy / wall_us:.2%}; {kernel} {kern[0]} launches x "
          f"{kern[1]:.3f} us device time")
    print(f"{label} device time by event (count, total us): " +
          "; ".join(f"{k[:60]} {n} {t:.1f}" for k, (n, t) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    return {"busy_share": busy / wall_us, "kernel": kern}


# ---------------------------------------------------------------------------
# phases 8-10: the fleet
# ---------------------------------------------------------------------------

def fleet_kernels(fleet) -> list:
    """Every step wrapper of a fleet: the device groups' and the shards'."""
    return ([k.kernel for k in fleet._group_kernels.values()]
            + [sh.kernel.kernel for sh in fleet.shards])


def count_fixed(kernels) -> None:
    """Zero each step wrapper's launches and see its library through a
    :class:`FixedCount` (a wrapper seen through already is left as it
    is)."""
    for k in kernels:
        if not isinstance(k._lib, FixedCount):
            k._lib = FixedCount(k._lib)
            k.launches = 0


def read_fixed(kernels) -> tuple:
    """(launches, fixed-width launches) of wrappers that
    :func:`count_fixed` set up, whose libraries it gives back."""
    launches = sum(k.launches for k in kernels)
    fixed = sum(k._lib.fixed for k in kernels)
    for k in kernels:
        k._lib = k._lib._lib
    return launches, fixed


def totals(feeds, i: int):
    kind = feeds.kind(i)
    return None if kind == "detach" else (256 if kind == "two" else 128)


def drive_fleet(torch, fleet, feeds, ids, *, verbs: bool):
    """``drive`` for a fleet: attach ``ids``, tick to the detach point,
    detach the mid-window streams, drain; with ``verbs``, migrate
    ``MIGRATED`` two-window streams live at ``MIGRATE_TICK`` and drain /
    return shard 1 at ``DECOMMISSION_TICK`` / ``RECOMMISSION_TICK``.
    Returns (events, per-tick seconds, wall seconds, steady-tick transfer
    delta, advancing ticks, verbs report)."""
    for i in ids:
        fleet.attach(f"s{i}", feeds.samples(i), total_steps=totals(feeds, i))
    events, ticks = [], []
    steady, advancing, report = None, 0, {}
    t_start = time.perf_counter()

    def tick(t):
        nonlocal steady, advancing
        before = fleet._stream_steps()
        if t == 10:   # a steady tick: nothing admitted or emitted
            tr0 = fleet.stats()["transfers"]
        t0 = time.perf_counter()
        events.extend(fleet.step())
        ticks.append(time.perf_counter() - t0)
        if t == 10:
            tr1 = fleet.stats()["transfers"]
            steady = {k: tr1[k] - tr0[k] for k in tr1}
        if fleet._stream_steps() == before:
            fail(f"fleet tick {t} advanced no stream while samples were "
                 "buffered")
        advancing += 1

    for t in range(DETACH_TICK):
        tick(t)
    for i in ids:
        if feeds.kind(i) == "detach":
            events.append(fleet.detach(f"s{i}"))
    t = DETACH_TICK
    while fleet._any_buffered():
        if verbs and t == MIGRATE_TICK:
            moved = [f"s{i}" for i in ids if feeds.kind(i) == "two"][:MIGRATED]
            t0 = time.perf_counter()
            report["migrate"] = [fleet.migrate(sid) for sid in moved]
            report["migrate_s"] = time.perf_counter() - t0
        if verbs and t == DECOMMISSION_TICK:
            t0 = time.perf_counter()
            report["decommissioned"] = len(fleet.decommission(1))
            report["decommission_s"] = time.perf_counter() - t0
        if verbs and t == RECOMMISSION_TICK:
            fleet.recommission(1)
        tick(t)
        t += 1
    torch.cuda.synchronize()
    return (events, ticks, time.perf_counter() - t_start, steady, advancing,
            report)


def tick_stats(np, ticks) -> str:
    """Percentiles of per-tick seconds, and the ticks over the 50 Hz
    budget of 20 ms."""
    ms = np.array(ticks) * 1e3
    p50, p95, p99 = np.percentile(ms, [50, 95, 99])
    return (f"tick p50 {p50:.3f} ms, p95 {p95:.3f} ms, p99 {p99:.3f} ms, "
            f"max {ms.max():.3f} ms; {int((ms > 20.0).sum())} over the 50 Hz "
            "budget of 20 ms")


def print_host(label: str, tr, steady, tracer) -> None:
    """A path's transfer ledger, its steady tick's delta, and the host
    phases of the span tracer."""
    print(f"{label}: transfers {tr}; steady tick {steady}")
    print(f"{label} host phases (count, total ms, p50 us, p99 us): " +
          "; ".join(f"{k} {v['count']} {v['total_us'] / 1e3:.1f} "
                    f"{v['p50_us']:.1f} {v['p99_us']:.1f}"
                    for k, v in tracer.phase_stats().items()))


def sample_ids():
    step = (SLOTS + EXTRA) // SAMPLED
    sample = sorted({k * step + (k % 16) for k in range(SAMPLED)}
                    | {SLOTS + 1, SLOTS + EXTRA - 1})
    return [i for i in sample if i < SLOTS + EXTRA]


def fleet_path(torch, np, dev, art, feeds, single, *, mxu: bool) -> dict:
    """The fleet main path on K2 (``mxu``) or K1.  ``single`` is the
    single-engine main path's per-stream events."""
    from repro_torch.obs import Observability, Tracer
    from repro_torch.serve.fleet import FleetConfig, FleetEngine
    from repro_torch.serve.streaming import StreamingConfig

    name = "K2 (q15_step_dense)" if mxu else "K1 (q15_step)"
    ids = list(range(SLOTS + EXTRA))
    obs = Observability(tracer=Tracer(capacity=1024))
    t0 = time.perf_counter()
    fleet = FleetEngine.from_artifact(art, FleetConfig(
        shards=SHARDS, max_pending_per_shard=0,
        stream=StreamingConfig(max_slots=SHARD_SLOTS, batch_events=True,
                               device=dev, mxu=mxu)), obs=obs)
    if len(fleet._group_list) != 1:
        fail(f"{len(fleet._group_list)} device groups on one card, want 1")
    kernels = fleet_kernels(fleet)
    count_fixed(kernels)                # count this path's run only
    events, ticks, wall, steady, advancing, report = drive_fleet(
        torch, fleet, feeds, ids, verbs=True)
    launches, fixed = read_fixed(kernels)
    if fixed != launches:
        fail(f"{name}: the fixed-width code ran on {fixed} of {launches} "
             f"launches")
    setup = time.perf_counter() - t0 - wall
    kinds = {type(k).__name__ for k in kernels if k.launches}
    want = "DenseStep" if mxu else "FastGRNNStep"
    if kinds != {want}:
        fail(f"fleet launched {kinds}, want only {want}")
    if launches != advancing:
        fail(f"{name}: launches {launches} != advancing fleet ticks "
             f"{advancing}")
    st = fleet.stats()
    expect = sum(DETACH_TICK if feeds.kind(i) == "detach"
                 else totals(feeds, i) for i in ids)
    if st["stream_steps"] != expect:
        fail(f"{name}: stream steps {st['stream_steps']} != {expect}")
    if st["migrations"] != len(report["migrate"]) + report["decommissioned"]:
        fail(f"{name}: migrations {st['migrations']}")
    tr = st["transfers"]
    if steady["h_h2d_bytes"] or steady["h_d2h_bytes"]:
        fail(f"{name}: steady tick moved h bytes: {steady}")
    got = per_stream(events, [f"s{i}" for i in ids])
    if mxu:
        # sampled streams against a CPU fleet on the plain dense step
        sample = sample_ids()
        cpu = FleetEngine.from_artifact(art, FleetConfig(
            shards=SHARDS, max_pending_per_shard=0,
            stream=StreamingConfig(max_slots=len(sample), device="cpu",
                                   batch_events=True, mxu=True)))
        ref = per_stream(drive_fleet(torch, cpu, feeds, sample,
                                     verbs=False)[0],
                         [f"s{i}" for i in sample])
        for sid, want_ev in ref.items():
            if not want_ev or got[sid] != want_ev:
                fail(f"{name} fleet stream {sid}: events {got[sid][:1]} != "
                     f"cpu fleet {want_ev[:1]}")
        # predictions against the K1 single engine
        n = same = 0
        for sid, want_ev in single.items():
            mine = got[sid]
            if [e[:3] for e in mine] != [e[:3] for e in want_ev]:
                fail(f"{name} fleet stream {sid}: event steps differ from "
                     "the K1 engine")
            n += len(want_ev)
            same += sum(a[3] == b[3] for a, b in zip(mine, want_ev))
        share = same / n
        print(f"fleet {name}: {len(sample)} sampled streams bitwise equal to "
              f"the CPU fleet on step_dense; {same} of {n} windows "
              f"({share:.4%}) predict as the K1 engine; K2's fixed-width "
              f"code on {fixed} of {launches} launches")
        if share < MIN_AGREEMENT:
            fail(f"{name}: prediction agreement {share:.4%} < "
                 f"{MIN_AGREEMENT:.1%}")
    else:
        if got != single:
            bad = next(sid for sid in single if got[sid] != single[sid])
            fail(f"{name} fleet stream {bad}: events differ from the "
                 f"single engine's")
        share = 1.0
        print(f"fleet {name}: all {len(single)} streams' events bitwise "
              f"equal to the single engine's; K1's fixed-width code on "
              f"{fixed} of {launches} launches")
    rate = st["stream_steps"] / wall
    print(f"fleet {name}: {SHARDS} shards x {SHARD_SLOTS} slots, "
          f"{len(ids)} streams, {len(ticks)} ticks ({advancing} advancing, "
          f"{launches} launches), {st['stream_steps']} stream-steps in "
          f"{wall:.3f} s = {rate:,.0f} stream-steps/s; "
          f"{tick_stats(np, ticks)}; set-up (build + attach) {setup:.1f} s")
    statuses = report["migrate"]
    print(f"fleet {name}: migrate {len(statuses)} streams at tick "
          f"{MIGRATE_TICK} "
          f"in {report['migrate_s'] * 1e3:.1f} ms "
          f"({statuses.count('active')} active, {statuses.count('pending')} "
          f"pending); decommission shard 1 at tick {DECOMMISSION_TICK}: "
          f"{report['decommissioned']} streams moved in "
          f"{report['decommission_s'] * 1e3:.1f} ms; recommission at tick "
          f"{RECOMMISSION_TICK}; global spills {st['global_spills']}")
    print_host(f"fleet {name}", tr, steady, obs.tracer)
    if mxu:
        profiled_window(torch, fleet, feeds, "q15_step_dense_kernel",
                        f"fleet {name} profiled window")
    del fleet
    return {"launches": launches, "rate": rate, "share": share}


def failover(torch, np, dev, art, feeds) -> None:
    """Failover on the card (K2): one crash at each tick phase against the
    same run without crashes, every event bitwise; every K2 launch of both
    runs (a crashed shard's replacement too) runs the fixed-width code."""
    from repro_torch.serve.fleet import (FleetConfig, FleetEngine,
                                         ScheduledFaults)
    from repro_torch.serve.streaming import StreamingConfig

    ids = range(SHARDS * FO_SLOTS)
    logs, recovery, seen = {}, [], []

    def watch(fleet):
        """Count the launches of every step wrapper the fleet has now."""
        kernels = fleet_kernels(fleet)
        count_fixed(kernels)
        seen.extend(k for k in kernels if k not in seen)

    for crashes in (True, False):
        fleet = FleetEngine.from_artifact(art, FleetConfig(
            shards=SHARDS, max_pending_per_shard=0,
            snapshot_every=FO_SNAPSHOT_EVERY,
            stream=StreamingConfig(max_slots=FO_SLOTS, batch_events=True,
                                   device=dev, mxu=True)),
            faults=ScheduledFaults(schedule=FO_CRASHES) if crashes else None)
        crash = fleet.crash_shard
        watch(fleet)

        def timed(shard, phase=None):
            t0 = time.perf_counter()
            out = crash(shard, phase=phase)
            torch.cuda.synchronize()
            recovery.append((time.perf_counter() - t0, out))
            watch(fleet)
            return out

        fleet.crash_shard = timed
        for i in ids:
            x = feeds.samples(i)
            fleet.attach(f"s{i}", x, total_steps=len(x))
        t0 = time.perf_counter()
        events = fleet.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = fleet.stats()
        logs[crashes] = per_stream(events, [f"s{i}" for i in ids])
        print(f"failover ({'3 crashes' if crashes else 'no crash'}): "
              f"{SHARDS} x {FO_SLOTS} slots, {len(ids)} streams, "
              f"{st['ticks']} ticks in {wall:.3f} s, failovers "
              f"{st['failovers']}, snapshots {st['snapshots']}, replayed "
              f"{st['replayed_samples']} samples, suppressed "
              f"{st['replay_suppressed']} events")
        del fleet
    if len(recovery) != len(FO_CRASHES):
        fail(f"{len(recovery)} crashes ran, want {len(FO_CRASHES)}")
    launches, fixed = read_fixed(seen)
    if not launches or fixed != launches:
        fail(f"failover: K2's fixed-width code ran on {fixed} of {launches} "
             "launches")
    if logs[True] != logs[False]:
        bad = next(s for s in logs[False] if logs[True][s] != logs[False][s])
        fail(f"failover: stream {bad} events differ from the run without "
             "crashes")
    for dt, rep in recovery:
        print(f"failover: shard {rep['shard']} crashed at {rep['phase']}: "
              f"{rep['streams_recovered']} streams recovered "
              f"({rep['replayed_samples']} samples to replay, "
              f"{rep['wire_bytes']} wire bytes) in {dt * 1e3:.1f} ms")
    print(f"failover: all {len(logs[False])} streams' events bitwise equal "
          f"to the run without crashes; K2's fixed-width code on {fixed} of "
          f"{launches} launches")


# ---------------------------------------------------------------------------
# phase 11: timing
# ---------------------------------------------------------------------------

def sleep_rate(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    torch.cuda.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def queued(torch, fn, sets, n: int, warm: int, cycles_per_ms: float):
    """(device ms, host ms, prefilled) per call of ``fn`` over ``sets``:
    the host's enqueue cost timed back to back, then the calls queued
    behind ``torch.cuda._sleep`` and timed with CUDA events, so they run
    back to back on the card whatever the host's rate (``prefilled`` says
    the queue really was full when the host finished enqueuing)."""
    for i in range(warm):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*sets[i % len(sets)])
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    torch.cuda._sleep(int(cycles_per_ms * (3 * host_ms * n + 5)))
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    b.record()
    prefilled = not a.query()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, host_ms, prefilled


# the kernels that --parent times beside this checkout's
PARENT_KERNELS = ("q15_step", "q15_step_dense", "q15_matmul", "ssd_scan")


def start_parent_builds(tree) -> dict:
    """Start nvcc on ``<tree>/src/repro_torch/csrc/<name>.cu`` for each of
    :data:`PARENT_KERNELS` (another checkout, e.g. the parent commit's),
    with this checkout's flags, one process each; {} without a tree."""
    if tree is None:
        return {}
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PARENT_KERNELS:
        src = os.path.join(tree, "src", "repro_torch", "csrc", f"{name}.cu")
        lib = _build.BUILD_DIR / f"lib{name}_parent.so"
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


_PARENT_LIBS: dict = {}


def finish_parent_builds(tree, procs: dict) -> None:
    """Wait for :func:`start_parent_builds`' processes and load each
    library; fails if one does not build."""
    import ctypes
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"the parent's {name}.cu ({tree}) does not build:\n{log}")
        _PARENT_LIBS[name] = ctypes.CDLL(str(lib))
        for line in log.splitlines():
            if name.startswith("q15_step") and ("stack frame" in line
                                                or "registers" in line):
                print(f"  parent {name}: {line.strip()}")
    if procs:
        print(f"build: the parent's {', '.join(procs)} from {tree}")


def parent_k1(sw, dev):
    """A :class:`FastGRNNStep` for ``sw`` whose launches run the parent's K1
    (its ``q15_step_launch``, the same C signature, bound through this
    wrapper's ``kernel._ARGTYPES``); None without a parent."""
    c = _PARENT_LIBS.get("q15_step")
    if c is None:
        return None
    import ctypes
    from repro_torch.kernels.fastgrnn_cell import kernel
    c.q15_step_launch.argtypes = kernel._ARGTYPES
    c.q15_step_launch.restype = ctypes.c_int
    c.q15_step_error_string.argtypes = [ctypes.c_int]
    c.q15_step_error_string.restype = ctypes.c_char_p
    step = kernel.FastGRNNStep(sw, dev)
    step._lib = c
    return step


def parent_k2(sw, dev):
    """A :class:`DenseStep` for ``sw`` whose launches run the parent's K2
    (its ``q15_step_dense_launch``, the same C signature, bound through
    this wrapper's ``kernel._DENSE_ARGTYPES``; no plan query); None without
    a parent."""
    c = _PARENT_LIBS.get("q15_step_dense")
    if c is None:
        return None
    import ctypes
    from repro_torch.kernels.fastgrnn_cell import kernel
    c.q15_step_dense_launch.argtypes = kernel._DENSE_ARGTYPES
    c.q15_step_dense_launch.restype = ctypes.c_int
    c.q15_step_dense_error_string.argtypes = [ctypes.c_int]
    c.q15_step_dense_error_string.restype = ctypes.c_char_p
    step = kernel.DenseStep(sw, dev)
    step._lib = c
    return step


def parent_k5():
    """K5 behind this checkout's wrapper with the parent's library (the same
    C interface, no plan query); None without a parent."""
    c = _PARENT_LIBS.get("q15_matmul")
    if c is None:
        return None
    import ctypes
    from repro_torch.kernels.q15_matmul import kernel
    c.q15_matmul_launch.argtypes = kernel._ARGTYPES
    c.q15_matmul_launch.restype = ctypes.c_int
    c.q15_matmul_error_string.argtypes = [ctypes.c_int]
    c.q15_matmul_error_string.restype = ctypes.c_char_p

    class ParentK5(kernel.Q15Matmul):
        _lib = c
    return ParentK5()


def parent_k6():
    """K6 behind this checkout's wrapper with the parent's library, as
    ``scan(x, dt, A, B, C, chunk=...) -> (y, state)`` in the per-head
    layout; None without a parent.  The parent's ``ssd_scan.cu`` must
    have this C interface (``ssd_scan_plan`` and the three phases)."""
    c = _PARENT_LIBS.get("ssd_scan")
    if c is None:
        return None
    from repro_torch.kernels.ssd_scan import kernel
    if not hasattr(c, "ssd_scan_plan"):
        fail("the parent's ssd_scan.cu has no ssd_scan_plan: it predates "
             "the three-phase K6 and its C interface")

    class ParentK6(kernel.SSDScan):
        _lib = kernel._bind(c)
    return ParentK6()


def k6_plan(torch, dtype, h, s, p, n, q, *, fill: bool) -> None:
    """Each K6 phase's grid, shared memory and resident blocks per SM at
    one shape, as the launcher reports them (``SSDScan.plan``); with
    ``fill``, fails unless P1 and P3 each have a block for every SM."""
    from repro_torch.kernels.ssd_scan.kernel import SSDScan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = SSDScan().plan(dtype, h, s, p, n, chunk=q)
    line = "; ".join(f"{ph['phase']}: {ph['blocks']} blocks x "
                     f"{ph['threads']} threads, {ph['smem']} B shared, "
                     f"{ph['per_sm']} per SM" for ph in plan)
    print(f"K6 plan at b=1 x S={s}, {h} heads of P={p}, N={n}, chunk {q}, "
          f"{str(dtype)[6:]} ({sms} SMs): {line}")
    if fill and min(plan[0]["blocks"], plan[2]["blocks"]) < sms:
        fail(f"K6 at S={s}: P1 {plan[0]['blocks']} / P3 "
             f"{plan[2]['blocks']} blocks, fewer than the {sms} SMs")


def timing_jobs(torch, sw, art) -> dict:
    """Every kernel at its main path's shapes, with its plain version, its
    input sets (together past the 50 MB L2), its call counts (kernel n,
    warm-up; plain n, warm-up) and the bytes and fp32 instructions its
    function needs (each input read once, each output written once)."""
    from repro_torch.kernels.fastgrnn_cell.kernel import (WindowScan,
                                                          make_fastgrnn_step)
    from repro_torch.kernels.fastgrnn_cell.ops import Q15StreamStep
    from repro_torch.kernels.lut_act.kernel import LUTAct

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    S, H, d = S_KERNEL, sw.hidden_dim, sw.input_dim
    sets = [(torch.randn(S, H, generator=g, device=dev) * 0.5,
             torch.randn(S, d, generator=g, device=dev),
             torch.ones(S, dtype=torch.bool, device=dev))
            for _ in range(TIMING_SETS)]
    jobs = {}
    for name, mxu in (("q15_step", False), ("q15_step_dense", True)):
        k = make_fastgrnn_step(sw, device=dev, mxu=mxu)
        roof = Q15StreamStep(sw, device=dev, mxu=mxu).roofline(1.0)
        jobs[name] = dict(
            kernel=k, plain=k.plain, sets=sets, counts=(200, 40, 6, 4),
            bytes=S * roof["hbm_bytes_per_stream_step"],
            ops=S * roof["model_flops_per_stream_step"],
            what=f"S={S} (one {S * H * 4} B output block reused)")
    for name, parent in (("q15_step", parent_k1(sw, dev)),
                         ("q15_step_dense", parent_k2(sw, dev))):
        if parent is not None:
            jobs[name]["parent"] = parent
    scan = WindowScan(art.require_qp().dequantize(), dev)
    xsets = [(torch.randn(W_STEPS, W_BATCH, d, generator=g, device=dev),)
             for _ in range(2)]
    jobs["fastgrnn_window"] = dict(
        kernel=scan, plain=scan.plain, sets=xsets, counts=(20, 3, 2, 1),
        bytes=(4 * d + 4 * H) * W_STEPS * W_BATCH + 4 * H * W_BATCH,
        ops=(2 * (d * H + H * H) + 13 * H) * W_STEPS * W_BATCH,
        what=f"B={W_BATCH} windows x T={W_STEPS}")
    act = LUTAct()
    n = LUT_TIMING_ELEMS
    for name, dtype in (("lut_act", torch.float32),
                        ("lut_act bfloat16", torch.bfloat16)):
        lsets = [((torch.randn(n, generator=g, device=dev) * 6).to(dtype),)
                 for _ in range(2)]
        jobs[name] = dict(
            kernel=lambda x: act(x, "tanh"),
            plain=lambda x: act.plain(x, "tanh"), sets=lsets,
            counts=(50, 5, 10, 2),
            bytes=2 * n * torch.finfo(dtype).bits // 8, ops=4 * n,
            what=f"tanh nearest over {n} {str(dtype)[6:]} values")
    # K5 at each LM path's head, at the rows the path launches it with (the
    # kernels line's row: the Qwen head's decode, 8 x 1536 x 151,936); each
    # job's weight sets pass L2 together
    from repro_torch.kernels.q15_matmul.kernel import Q15Matmul, plain
    mm, parent = Q15Matmul(), parent_k5()
    heads = k5_heads()
    scale = torch.tensor(0.0021, device=dev)
    qwen = {}
    for name, arch, m, dtype in (
            ("q15_matmul", LM_ARCH, LM_SLOTS, torch.int16),
            ("q15_matmul int8", LM_ARCH, LM_SLOTS, torch.int8),
            ("q15_matmul prefill", LM_ARCH, 1, torch.int16),
            ("q15_matmul mamba2", SSM_ARCH, LM_SLOTS, torch.int16),
            ("q15_matmul zamba2", HYBRID_ARCH, HYBRID_SLOTS, torch.int16)):
        k, n = heads[arch]
        size = torch.iinfo(dtype).bits // 8
        hi = 30000 if dtype == torch.int16 else 120
        nsets = max(2, -(-2 * L2_BYTES // (size * k * n)))
        ws = qwen.get(dtype) if arch == LM_ARCH else None
        if ws is None:
            ws = [torch.randint(-hi, hi, (k, n), generator=g,
                                device=dev).to(dtype) for _ in range(nsets)]
            if arch == LM_ARCH:
                qwen[dtype] = ws
        msets = [(torch.randn(m, k, generator=g, device=dev), w, scale)
                 for w in ws]
        # the yardstick: torch.mm of bf16 x against the same weights in
        # bf16 (2 bytes a weight), converted once beforehand
        bsets = [(x.to(torch.bfloat16), w.to(torch.bfloat16))
                 for x, w, _ in msets]
        plan = mm.plan(ws[0], m)
        jobs[name] = dict(
            kernel=mm, plain=plain, sets=msets,
            counts=(100, 10, 10, 2), library=torch.mm, library_sets=bsets,
            bytes=4 * m * k + size * k * n + 4 + 4 * m * n,
            # products of two bfloat16 values on the tensor cores, float32
            # sums; one multiply by the scale per output beside them
            ops=2 * m * k * n,
            ops_ms=max(2 * m * k * n / BF16_FLOP_PER_S,
                       m * n / FP32_OPS_PER_S) * 1e3,
            ops_what=f"{2 * m * k * n} bfloat16 tensor-core FLOP over 989 "
                     f"T/s (the {m * n} scale multiplies over 33.5 T/s "
                     f"beside them)",
            what=f"M={m} x K={k} x N={n}, {str(dtype)[6:]} weights ({arch} "
                 f"head; plan: {plan[0]} loads, {plan[1]} column tile(s) "
                 f"per warp)")
        if parent is not None:
            jobs[name]["parent"] = parent
    # K6 at the SSM path's prefill shape: b = 1 x S = K6_TIMING_S tokens at
    # mamba2-780m width, bfloat16 x / B / C (the engine's compute dtype) in
    # the kernel's per-head layout (the one group of B and C broadcast over
    # the heads, as ops.ssd_scan hands them over); four sets of 31 MB.
    # Beside it a one-chunk prompt and the same shape in float32.
    from repro_torch import configs
    from repro_torch.kernels.ssd_scan.kernel import SSDScan
    from repro_torch.kernels.ssd_scan.kernel import plain as k6_plain
    c = configs.get(SSM_ARCH)
    h, p, n, q = (2 * c.d_model // c.mamba_headdim, c.mamba_headdim,
                  c.ssm_state, c.ssd_chunk)
    scan, k6_parent = SSDScan(), parent_k6()

    def k6_set(s, dtype):
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev)
        return (rnd(h, s, p).to(dtype),
                torch.nn.functional.softplus(rnd(h, s, 1)),
                -torch.exp(rnd(h, 1)),
                rnd(1, s, n).to(dtype).expand(h, s, n).contiguous(),
                rnd(1, s, n).to(dtype).expand(h, s, n).contiguous())
    for name, s, dtype in (("ssd_scan", K6_TIMING_S, torch.bfloat16),
                           ("ssd_scan one-chunk", q, torch.bfloat16),
                           ("ssd_scan float32", K6_TIMING_S, torch.float32)):
        k6_plan(torch, dtype, h, s, p, n, q, fill=s == K6_TIMING_S)
        mma = dtype == torch.bfloat16
        ops_ms, best_q, fp32, flop = ssd_least_work(h, 1, s, p, n,
                                                    tensor_cores=mma)
        e = torch.finfo(dtype).bits // 8
        jobs[name] = dict(
            kernel=lambda *a: scan(*a, chunk=q),
            plain=lambda *a: k6_plain(*a, chunk=q),
            sets=[k6_set(s, dtype) for _ in range(4)], counts=(30, 3, 4, 1),
            # per head x and y in x's dtype, dt and A in float32, the state
            # in float32; B and C in x's dtype once for their one group
            bytes=h * (2 * s * p * e + s * 4 + 4 + n * p * 4) + 2 * s * n * e,
            ops=fp32 + flop, ops_ms=ops_ms,
            ops_what=f"the least over chunk lengths, at {best_q}: {fp32} "
                     f"fp32 instructions over 33.5 T/s" + (
                         f", {flop} bfloat16 tensor-core FLOP over 989 T/s "
                         f"(C B^T exact; M x, C H and the state sums as "
                         f"three bfloat16 parts)"
                         if mma else " (every product: float32 products "
                                     "are not exact in bfloat16)"),
            prof=[f"ssd_scan_p{k}_" for k in (1, 2, 3)],
            what=f"b=1 x S={s} at mamba2-780m width ({h} heads of P={p}, "
                 f"N={n}, chunk {q}), {str(dtype)[6:]}")
        if k6_parent is not None:
            jobs[name]["parent"] = lambda *a: k6_parent(*a, chunk=q)
    for job in jobs.values():
        job["in_bytes"] = sum(t.numel() * t.element_size()
                              for st in job["sets"] for t in st)
    return jobs


def ssd_least_work(h, g, s, p, n, *, tensor_cores: bool = True) -> tuple:
    """The SSD scan's least operations for h heads (P = p) over g groups
    of B and C (N = n) and s tokens: its y and final state do not depend
    on the chunk length, so this is the chunked algorithm at the length
    that needs the least time (length 1 is the recurrence).  Per chunk of
    k rows: C B^T over its lower triangle once per group (N multiply-adds
    an entry); per head M x over the triangle (P an entry), C H and the
    state sums (N P a row each), and in float32 four operations per M
    entry (its difference, exp and two multiplies) and N P for the state's
    decay.  With ``tensor_cores`` (bfloat16 inputs) every product runs on
    the bfloat16 tensor cores, 2 FLOP a multiply-add: C B^T as it is (a
    product of two bfloat16 values is exact in float32), M x, C H and the
    state sums as three exact bfloat16 parts of their float32 operand (6
    FLOP); the split itself is not counted.  Without (float32 inputs,
    whose products are not exact in bfloat16) every multiply-add is one
    float32 FMA.  The two units issue side by side, so the time is the
    larger of theirs.  Returns (ms, chunk length, float32 instructions,
    tensor-core FLOP)."""
    best = None
    for q in range(1, s + 1):
        ks = [min(q, s - c0) for c0 in range(0, s, q)]
        tri = sum(k * (k + 1) // 2 for k in ks)
        cb, mx, ch = g * tri * n, h * tri * p, 2 * h * s * n * p
        fp32 = h * (4 * tri + len(ks) * n * p)
        if tensor_cores:
            flop = 2 * cb + 6 * (mx + ch)
        else:
            fp32, flop = fp32 + cb + mx + ch, 0
        ms = max(fp32 / FP32_OPS_PER_S, flop / BF16_FLOP_PER_S) * 1e3
        if best is None or ms < best[0]:
            best = (ms, q, fp32, flop)
    return best


def timing(torch, sw, art, tree=None) -> dict:
    """Per-call times of every kernel and of its plain version at the
    shapes of its main path, side by side in one process: device time of
    calls queued behind a sleep (CUDA events) and the host's enqueue cost
    (:func:`queued`), each kernel's device time also read from a
    torch.profiler trace, and its bound: the larger of its bytes over
    3.35 TB/s and its fp32 instructions over their issue rate.
    Rounds run every kernel, then every plain version, and then both in
    the reverse order.  With a parent ``tree`` (built in phase 2), its K1,
    K2, K5 and K6 run in turns beside this checkout's."""
    from torch.profiler import ProfilerActivity, profile

    jobs = timing_jobs(torch, sw, art)
    cycles_per_ms = sleep_rate(torch)
    kern = {n: [] for n in jobs}
    plain = {n: [] for n in jobs}
    lib = {n: [] for n in jobs if "library" in jobs[n]}
    par = {n: [] for n in jobs if "parent" in jobs[n]}
    order = list(jobs)
    for first, names in ((True, order), (False, order[::-1])):
        for n in names:
            nk, wk, _, _ = jobs[n]["counts"]
            # parent, kernel in the first round; kernel, parent in the second
            for who in (("parent", "kernel") if first else
                        ("kernel", "parent")):
                if who == "kernel":
                    kern[n].append(queued(torch, jobs[n]["kernel"],
                                          jobs[n]["sets"], nk, wk,
                                          cycles_per_ms))
                elif n in par:
                    par[n].append(queued(torch, jobs[n]["parent"],
                                         jobs[n]["sets"], nk, wk,
                                         cycles_per_ms))
            if n in lib:
                lib[n].append(queued(torch, jobs[n]["library"],
                                     jobs[n]["library_sets"], nk, wk,
                                     cycles_per_ms))
        for n in names:
            _, _, npl, wpl = jobs[n]["counts"]
            plain[n].append(queued(torch, jobs[n]["plain"], jobs[n]["sets"],
                                   npl, wpl, cycles_per_ms))

    def fmt(rows, digits):
        return ", ".join(f"device {r[0] * 1e3:.{digits}f} us / host "
                         f"{r[1] * 1e3:.{digits}f} us"
                         f"{'' if r[2] else ' (queue drained: host-bound)'}"
                         for r in rows)

    out = {}
    for n, job in jobs.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(job["counts"][0]):
                job["kernel"](*job["sets"][i % len(job["sets"])])
            torch.cuda.synchronize()
        if "prof" in job:               # one launch of each phase a call
            phases = [kernel_device_us(prof, k) for k in job["prof"]]
            prof_k = None if None in phases else (
                phases[0][0], sum(ph[1] for ph in phases))
            print(f"timing {n}: device time by phase from the profiler: " +
                  "; ".join(f"{k} " + ("not measured" if ph is None else
                                       f"{ph[1]:.3f} us over {ph[0]} "
                                       f"launches")
                            for k, ph in zip(job["prof"], phases)))
        else:
            prof_k = kernel_device_us(prof, f"{n.split()[0]}_kernel")
        t_bytes = job["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = job.get("ops_ms", job["ops"] / FP32_OPS_PER_S * 1e3)
        ops_what = job.get("ops_what",
                           f"{job['ops']} fp32 instructions over 33.5 T/s")
        bound = max(t_bytes, t_ops)
        ms = min(r[0] for r in kern[n])
        host_ms = min(r[1] for r in kern[n])
        print(f"timing {n} {job['what']} over {len(job['sets'])} input sets "
              f"({job['in_bytes']} B of inputs), queued behind a sleep: "
              f"kernel [{fmt(kern[n], 3)}]; plain [{fmt(plain[n], 1)}] per "
              f"call")
        print(f"timing {n}: device time from the profiler "
              f"{'not measured (no device event)' if prof_k is None else f'{prof_k[1]:.3f} us over {prof_k[0]} launches'}"
              f"; the {'host enqueue' if host_ms > ms else 'device'} bounds "
              f"back-to-back launches (host {host_ms * 1e3:.3f} us vs device "
              f"{ms * 1e3:.3f} us)")
        lib_ms = min(r[0] for r in lib[n]) if n in lib else None
        print(f"timing {n}: bound {bound * 1e3:.3f} us ({job['bytes']} B over "
              f"3.35 TB/s = {t_bytes * 1e3:.3f} us; {ops_what} = "
              f"{t_ops * 1e3:.3f} us); kernel at "
              f"{bound / ms:.1%} of the bound; " + (
                  "no single PyTorch call computes this function, so there "
                  "is no library yardstick" if lib_ms is None else
                  f"library yardstick torch.mm of bfloat16 x against the "
                  f"weights in bfloat16 (the bytes of int16, not the same "
                  f"function) [{fmt(lib[n], 3)}] per call"))
        if n in ("q15_step", "q15_step_dense"):
            k = "K1" if n == "q15_step" else "K2"
            print(f"timing {n}: " + (
                f"the parent's {k} ({tree}, same card, in turns parent, {k}, "
                f"{k}, parent) [{fmt(par[n], 3)}] per call: "
                f"{min(r[0] for r in par[n]) / ms:.3f} x faster"
                if n in par else f"no parent {k} given"))
        if n.startswith("q15_matmul"):
            print(f"timing {n}: {job['bytes'] / ms / 1e6:,.0f} GB/s of its "
                  f"bytes; " + ("" if lib_ms is None else
                                f"{ms / lib_ms:.3f} x the torch.mm "
                                f"yardstick's time; ") + (
                      f"the parent's K5 ({tree}, same card, in turns "
                      f"parent, K5, K5, parent) [{fmt(par[n], 3)}] per "
                      f"call: {min(r[0] for r in par[n]) / ms:.3f} x faster"
                      if n in par else "no parent K5 given"))
        if n.startswith("ssd_scan"):
            print(f"timing {n}: " + (
                f"the parent's K6 ({tree}, same card, in turns "
                f"parent, K6, K6, parent) [{fmt(par[n], 3)}] per call: "
                f"{min(r[0] for r in par[n]) / ms:.3f} x faster"
                if n in par else "no parent K6 given"))
        out[n] = {"ms": ms, "plain_ms": min(r[0] for r in plain[n]),
                  "bound_ms": bound, "library_ms": lib_ms,
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    w = out["fastgrnn_window"]["ms"]
    print(f"timing fastgrnn_window: {W_BATCH / w * 1e3:,.0f} windows/s "
          f"({W_BATCH * W_STEPS / w * 1e3:,.0f} window-steps/s) on one card")
    return out


# ---------------------------------------------------------------------------
# phases 12-14: the LM serving path at full width (Qwen2-1.5B, then the
# Mamba-2 families: mamba2-780m and zamba2-1.2b)
# ---------------------------------------------------------------------------

def quantize_on_card(torch, params) -> None:
    """``quantize_tree`` on the card against the CPU, bitwise (integers
    and scales, int16 and int8), on three full-size leaves of the model."""
    from repro_torch.compress.tree import quantize_tree
    from repro_torch.pytree import tree_map
    blocks = params["blocks"]
    leaves = {"embed.table": params["embed"]["table"],
              "attn.q.w[0]": blocks["attn"]["q"]["w"][0],
              "mlp.w_out.w[0]": blocks["mlp"]["w_out"]["w"][0]}
    host = tree_map(lambda t: t.cpu(), leaves)
    t0 = time.perf_counter()
    for bits in (16, 8):
        q_dev, s_dev = quantize_tree(leaves, bits)
        q_cpu, s_cpu = quantize_tree(host, bits)
        for name in leaves:
            got = q_dev[name].cpu()
            if not torch.equal(got, q_cpu[name]):
                n = int((got != q_cpu[name]).sum())
                fail(f"quantize_tree int{bits} {name}: {n} integers differ "
                     "between the card and the CPU")
            if not bits_equal(s_dev[name].cpu(), s_cpu[name]):
                fail(f"quantize_tree int{bits} {name}: scale "
                     f"{float(s_dev[name])!r} on the card, "
                     f"{float(s_cpu[name])!r} on the CPU")
    print("quantize_tree card == CPU bitwise (int16 and int8 integers and "
          "scales): " + ", ".join(f"{k} {tuple(v.shape)}"
                                  for k, v in leaves.items())
          + f" in {time.perf_counter() - t0:.1f} s")


def lm_requests(np, vocab: int, n: int, prompt, new) -> list:
    """``n`` (prompt, max_new) pairs from seed SEED: prompt lengths and
    budgets uniform over the inclusive ranges ``prompt`` and ``new``."""
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(n):
        k = int(rng.integers(prompt[0], prompt[1] + 1))
        m = int(rng.integers(new[0], new[1] + 1))
        reqs.append((rng.integers(0, vocab, k).astype(np.int32), m))
    return reqs


def init_lm(torch, dev, cfg):
    """The model at full width, weights drawn by ``models.transformer.init``
    from a CUDA generator seeded SEED; prints what was drawn."""
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_leaves
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    by_dtype = {}
    for t in tree_leaves(params):
        by_dtype[str(t.dtype)[6:]] = by_dtype.get(str(t.dtype)[6:], 0) \
            + t.numel()
    shape = [f"{cfg.num_layers} layers", f"d_model {cfg.d_model}"]
    if cfg.family == "dense":
        shape.append(f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads "
                     f"of {cfg.head_dim}, d_ff {cfg.d_ff} {cfg.mlp_kind}")
    if cfg.family == "moe":
        shape.append(f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads "
                     f"of {cfg.head_dim}, {cfg.num_experts} experts top-"
                     f"{cfg.top_k} of d_ff {cfg.d_ff} {cfg.mlp_kind}, "
                     f"capacity factor {cfg.capacity_factor}")
    if cfg.uses_mamba:
        shape.append(f"mamba d_inner {2 * cfg.d_model}, "
                     f"{2 * cfg.d_model // cfg.mamba_headdim} SSM heads of "
                     f"{cfg.mamba_headdim}, {cfg.mamba_groups} group, state "
                     f"{cfg.ssm_state}, chunk {cfg.ssd_chunk}")
    if cfg.family == "hybrid":
        shape.append(f"one shared attention block ({cfg.num_heads} heads of "
                     f"{cfg.head_dim}, d_ff {cfg.d_ff} {cfg.mlp_kind}) after "
                     f"every {cfg.attn_every} mamba layers")
    shape.append(f"vocab {cfg.vocab_size}, "
                 f"{'tied' if cfg.tie_embeddings else 'untied'} head")
    print(f"{cfg.name} ({cfg.family}) at full width: {', '.join(shape)}; "
          f"{sum(by_dtype.values()):,} parameters ("
          + ", ".join(f"{n:,} {k}" for k, n in by_dtype.items())
          + f"; param_dtype {cfg.param_dtype}, the full-rank dense weights "
          f"float32 as in the reference's init) from a CUDA generator seeded "
          f"{SEED} in {time.perf_counter() - t0:.1f} s")
    return params


def ssd_plain(torch, x, dt, A, B, C, chunk: int):
    """K6's plain version in the model layout (``ops.ssd_scan``'s fold:
    groups broadcast over their heads, batch x heads folded)."""
    from repro_torch.kernels.ssd_scan.kernel import plain
    b, s, h, p = x.shape
    n = B.shape[3]

    def fold(t, width):
        t = t.repeat_interleave(h // t.shape[2], dim=2)
        return t.movedim(2, 1).reshape(b * h, s, width)
    y, st = plain(fold(x, p), fold(dt.float()[..., None], 1),
                  A.float().repeat(b).reshape(b * h, 1), fold(B, n),
                  fold(C, n), chunk=chunk)
    return y.reshape(b, h, s, p).movedim(1, 2), st.reshape(b, h, n, p)


def k6_error(torch, y, st, want_y, want_st, what: str) -> float:
    """Hold one K6 output against the plain version's on the same inputs;
    returns max |K6 y - plain y|.  float32: y and state within rtol = atol
    = K6_TOL (the reference's bound).  bfloat16: y within K6_BF16_REL x
    max|y| plus one bfloat16 ulp of plain's y (both sum in float32 and
    round once, in different orders); the float32 state as in float32."""
    yf, wf = y.float(), want_y.float()
    diff = (yf - wf).abs()
    if y.dtype == torch.float32:
        lim = K6_TOL + K6_TOL * wf.abs()
    else:
        ulp = torch.ldexp(torch.ones_like(wf), torch.frexp(wf)[1] - 8)
        lim = K6_BF16_REL * float(wf.abs().max()) + ulp
    if not bool((diff <= lim).all()):
        i = int((diff - lim).argmax())
        fail(f"K6 != plain ({what}): |diff| {float(diff.flatten()[i]):.3e} "
             f"over its bound {float(lim.flatten()[i]):.3e} at flat index "
             f"{i}; max |diff| {float(diff.max()):.3e}")
    sdiff = (st - want_st).abs()
    if not bool((sdiff <= K6_TOL + K6_TOL * want_st.abs()).all()):
        fail(f"K6 state != plain ({what}): max |diff| "
             f"{float(sdiff.max()):.3e}")
    return float(diff.max())


def ssd_vs_plain(torch, np, dev) -> None:
    """K6 against its plain version on the card: the reference test's three
    shapes, and b = 2, S = 1000 at mamba2-780m's and zamba2-1.2b's head
    layouts (chunk 256: four chunks, the last ragged), float32 and
    bfloat16 x / B / C, inputs drawn as the reference test draws them; the
    plain version on the card against the CPU's on a few heads."""
    from repro_torch.kernels.ssd_scan import ops
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    shapes = [(1, 32, 2, 8, 1, 8, 8), (2, 80, 4, 8, 2, 16, 16),
              (2, 100, 4, 16, 4, 8, 32)] + [
        (2, 1000, 2 * c.d_model // c.mamba_headdim, c.mamba_headdim,
         c.mamba_groups, c.ssm_state, c.ssd_chunk) for c in mamba_cfgs()]
    cases, full = 0, []
    for b, s, h, p, gr, n, chunk in shapes:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev)
        x, B, C = rnd(b, s, h, p), rnd(b, s, gr, n), rnd(b, s, gr, n)
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        A = -torch.exp(rnd(h))
        for dtype in (torch.float32, torch.bfloat16):
            xs, Bs, Cs = (t.to(dtype) for t in (x, B, C))
            what = f"{str(dtype)[6:]} b={b} S={s} H={h} P={p} G={gr} " \
                   f"N={n} chunk={chunk}"
            y, st = ops.ssd_scan(xs, dt, A, Bs, Cs, chunk=chunk)
            want_y, want_st = ssd_plain(torch, xs, dt, A, Bs, Cs, chunk)
            err = k6_error(torch, y, st, want_y, want_st, what)
            cases += 1
            if s == 1000:
                full.append(f"{str(dtype)[6:]} H={h} N={n} {err:.3e}")
            if s == 1000 and dtype == torch.float32:
                # plain on the card == plain on the CPU (same cumsum order;
                # only the matmuls' sums differ), on the first two heads
                cpu = [t[:, :, :2].cpu() for t in (xs, dt)] + [A[:2].cpu()]
                cy, cst = ssd_plain(torch, cpu[0], cpu[1], cpu[2],
                                    Bs.cpu(), Cs.cpu(), chunk)
                dy = (want_y[:, :, :2].cpu() - cy).abs()
                if not bool((dy <= K6_TOL + K6_TOL * cy.abs()).all()) or \
                        not torch.allclose(want_st[:, :2].cpu(), cst,
                                           rtol=K6_TOL, atol=K6_TOL):
                    fail(f"K6 plain on the card != plain on the CPU ({what}):"
                         f" max |diff| {float(dy.max()):.3e}")
    torch.cuda.synchronize()
    print(f"K6 vs plain: {cases} cases (the reference test's three shapes "
          f"and b=2 x S=1000 at mamba2-780m's and zamba2-1.2b's head layouts, "
          f"float32 and bfloat16) within rtol = atol = {K6_TOL} (float32) / "
          f"{K6_BF16_REL} x max|y| + one bfloat16 ulp (bfloat16 y); largest "
          f"|y diff| at S=1000: {'; '.join(full)}; plain on the card within "
          f"{K6_TOL} of the CPU's on two heads; in "
          f"{time.perf_counter() - t0:.1f} s")


# (BH, S, P, N, chunk) of the launcher's branches that phase 4's shapes do
# not reach: one row; N = 100 and P = 80 (two P tiles, B and C rows not
# 16-byte aligned); N x P odd (the state pass one element a thread, no
# 16-byte load anywhere); three P tiles at a 512-row chunk
K6_EDGES = ((2, 1, 64, 128, 256), (2, 300, 80, 100, 100), (3, 77, 5, 7, 13),
            (2, 700, 130, 128, 512))


def ssd_edges(torch, dev) -> None:
    """K6 through its wrapper against the plain version on the branches
    of its launcher that the model's shapes do not take (K6_EDGES), in
    float32 and bfloat16, and once on inputs that start one element past
    a 16-byte boundary (the loads without vectors); phase 4's bounds."""
    from repro_torch.kernels.ssd_scan.kernel import SSDScan
    from repro_torch.kernels.ssd_scan.kernel import plain
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    scan, cases = SSDScan(), 0

    def rnd(n, *shape):
        return torch.randn(n, generator=g, device=dev).view(*shape)
    for (bh, s, p, n, q), skew in [(e, 0) for e in K6_EDGES] + [
            (K6_EDGES[3], 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(bh * s * p, bh, s, p).to(dtype)
            B, C = (rnd(bh * s * n, bh, s, n).to(dtype) for _ in range(2))
            if skew:
                x, B, C = (torch.empty(t.numel() + skew, dtype=dtype,
                                       device=dev)[skew:].view(t.shape)
                           .copy_(t) for t in (x, B, C))
            dt = torch.nn.functional.softplus(rnd(bh * s, bh, s, 1))
            A = -torch.exp(rnd(bh, bh, 1))
            y, st = scan(x, dt, A, B, C, chunk=q)
            want_y, want_st = plain(x, dt, A, B, C, chunk=q)
            k6_error(torch, y, st, want_y, want_st,
                     f"edge {str(dtype)[6:]} BH={bh} S={s} P={p} N={n} "
                     f"chunk={q}{' unaligned' if skew else ''}")
            cases += 1
    torch.cuda.synchronize()
    print(f"K6 edges: {cases} cases (BH, S, P, N, chunk) in {K6_EDGES}, "
          f"float32 and bfloat16, the last also one element off a 16-byte "
          f"boundary, within phase 4's bounds of the plain version")


def mamba_cfgs():
    """The configs of the Mamba-2 families' paths (phases 13 and 14)."""
    from repro_torch import configs
    return [configs.get(a) for a in (SSM_ARCH, HYBRID_ARCH)]


def serve_lm(torch, np, dev, card, cfg, params, *, slots: int,
             max_len: int, reqs: list, label: str) -> dict:
    """``Engine(quant_bits=16)`` on ``cuda`` over ``reqs``, the launch
    counts zeroed just before the run and read just after.  Every K5 call
    (the head) and every K6 call (each mamba layer's prefill scan) is
    recorded and held against its plain version on the same inputs after
    the run; every request must complete with its budget of tokens in
    [0, vocab); K5 launches = prefills + decode ticks, K6 launches =
    prefills x layers (0 without mamba layers).  Returns the launches, the
    largest differences and the engine."""
    from repro_torch.kernels.q15_matmul.kernel import Q15Matmul
    from repro_torch.kernels.q15_matmul.kernel import plain as k5_plain
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import SSDScan
    from repro_torch.obs import MetricsRegistry, Observability, Tracer
    from repro_torch.serve.engine import Engine, ServeConfig

    torch.cuda.reset_peak_memory_stats()
    # the engine's own spans time the run: lm.prefill and lm.decode end in
    # the sampled tokens' copy to the host, so each holds its device work
    obs = Observability(tracer=Tracer(), metrics=MetricsRegistry())
    t0 = time.perf_counter()
    eng = Engine(cfg, params, ServeConfig(max_len=max_len, max_slots=slots,
                                          quant_bits=16),
                 obs=obs, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    wq, scale = eng._head_wq, eng._head_scale
    if tuple(wq.shape) != (cfg.d_model, cfg.vocab_size) or \
            wq.dtype != torch.int16:
        fail(f"{label}: engine head {tuple(wq.shape)} {wq.dtype}, want "
             f"({cfg.d_model}, {cfg.vocab_size}) int16")
    heads, scans = [], []       # (inputs, outputs) of every K5 / K6 call
    head, scan = eng._head_logits, ssd_ops.ssd_scan

    def recorded_head(hidden):
        out = head(hidden)
        heads.append((hidden[:, -1, :].float(), out))
        return out

    def recorded_scan(x, dt, A, B, C, *, chunk):
        y, st = scan(x, dt, A, B, C, chunk=chunk)
        scans.append((x, dt, A, B, C, chunk, y, st))
        return y, st
    eng._head_logits, ssd_ops.ssd_scan = recorded_head, recorded_scan
    Q15Matmul.launches = SSDScan.launches = 0   # this path's run only
    rids = [eng.submit(toks, new) for toks, new in reqs]
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5, k6 = Q15Matmul.launches, SSDScan.launches
    eng._head_logits, ssd_ops.ssd_scan = head, scan
    st = eng.stats()
    spans = obs.tracer.phase_stats()
    for rid, (toks, new) in zip(rids, reqs):
        out = eng.result(rid)
        if out.shape != (new,) or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{label}: request {rid}: {out.shape[0]} tokens in "
                 f"[{out.min()}, {out.max()}], want {new} in "
                 f"[0, {cfg.vocab_size})")
    if st["prefills"] != len(reqs) or st["tokens_generated"] != sum(
            new for _, new in reqs):
        fail(f"{label}: engine stats {st}")
    if k5 != st["prefills"] + st["decode_ticks"] or len(heads) != k5:
        fail(f"{label}: K5 launches {k5}, head calls {len(heads)}, prefills "
             f"+ decode ticks {st['prefills'] + st['decode_ticks']}")
    want_k6 = st["prefills"] * cfg.num_layers if cfg.uses_mamba else 0
    if k6 != want_k6 or len(scans) != k6:
        fail(f"{label}: K6 launches {k6}, scan calls {len(scans)}, want "
             f"prefills x layers = {want_k6}")
    if (spans["lm.prefill"]["count"], spans["lm.decode"]["count"]) != (
            st["prefills"], st["decode_ticks"]):
        fail(f"{label}: engine spans {spans} against stats {st}")
    peak = torch.cuda.max_memory_allocated()
    held = sum(t.numel() * t.element_size() for rec in scans for t in rec
               if isinstance(t, torch.Tensor))
    held += sum(t.numel() * t.element_size() for rec in heads for t in rec)

    t0 = time.perf_counter()
    k5_err, close, rows = 0.0, 0, 0
    for x, out in heads:
        want = k5_plain(x, wq, scale)
        diff = (out - want).abs().amax(dim=1)
        lim = K5_REL * float(want.abs().max())
        if not float(diff.max()) <= lim:
            fail(f"{label} head: K5 vs plain max |diff| "
                 f"{float(diff.max()):.3e} > {lim:.3e}")
        top2 = want.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * diff
        if not torch.equal(out.argmax(1)[clear], want.argmax(1)[clear]):
            fail(f"{label} head: K5's argmax differs from the plain "
                 "version's on a row whose top-2 margin exceeds twice the "
                 "difference")
        k5_err = max(k5_err, float(diff.max()))
        close += int((~clear).sum())
        rows += x.shape[0]
    k6_err = 0.0
    while scans:
        x, dt, A, B, C, chunk, y, sst = scans.pop()
        want_y, want_st = ssd_plain(torch, x, dt, A, B, C, chunk)
        k6_err = max(k6_err, k6_error(torch, y, sst, want_y, want_st,
                                      f"{label}, S={x.shape[1]}"))
    torch.cuda.synchronize()
    check = time.perf_counter() - t0
    sch = st["scheduler"]
    tokens = st["tokens_generated"]
    pre, dec, tick = (spans[n] for n in ("lm.prefill", "lm.decode",
                                         "lm.tick"))
    print(f"{label}: {len(reqs)} requests (prompts "
          f"{sum(len(t) for t, _ in reqs)} tokens, budgets {tokens} tokens) "
          f"over {slots} slots, max_len {max_len}, quant_bits 16: "
          f"{st['prefills']} prefills + {st['decode_ticks']} decode ticks, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:,.1f} tokens/s; "
          f"spans lm.prefill p50 {pre['p50_us'] / 1e3:.3f} ms / p99 "
          f"{pre['p99_us'] / 1e3:.3f} ms ({pre['count']}), lm.decode p50 "
          f"{dec['p50_us'] / 1e3:.3f} ms / p99 {dec['p99_us'] / 1e3:.3f} ms "
          f"({dec['count']}), lm.tick p50 {tick['p50_us'] / 1e3:.3f} ms / "
          f"p99 {tick['p99_us'] / 1e3:.3f} ms ({tick['count']}); scheduler "
          f"admissions {sch['admissions']}, recycles {sch['recycles']}, "
          f"spills {sch['spills']}, peak active {sch['peak_active']}; "
          f"engine set-up (quantize, dequantize, head layout) {setup:.1f} s; "
          f"peak device memory {peak:,} B ({peak / 2**30:.2f} GiB, of which "
          f"{held / 2**30:.2f} GiB the recorded K5 / K6 inputs and outputs "
          f"kept for the check); card {card}")
    print(f"{label}: K5 launched {k5} times = prefills + decode ticks, every "
          f"head output within {K5_REL} x max|plain| of the plain version "
          f"(largest |diff| {k5_err:.3e}), argmax equal on every row whose "
          f"top-2 margin exceeds twice its difference ({close} of {rows} "
          f"rows under that margin); " + (
              f"K6 launched {k6} times = prefills x {cfg.num_layers} "
              f"layers, every output within its bound of the plain version "
              f"(largest |y diff| {k6_err:.3e})" if cfg.uses_mamba else
              "no mamba layer, so no K6 launch")
          + f"; checks in {check:.1f} s")
    return {"eng": eng, "k5": k5, "k5_err": k5_err, "k6": k6,
            "k6_err": k6_err}


def lm_path(torch, np, dev, card) -> dict:
    """Phase 12: the LM ``Engine`` at full Qwen2-1.5B width through its Q15
    head (K5), every head call checked against the plain version; then the
    same weights in float32 through the slotted decode (see
    :func:`lm_decode_continuity`)."""
    from repro_torch import configs
    cfg = configs.get(LM_ARCH)
    params = init_lm(torch, dev, cfg)
    quantize_on_card(torch, params)
    reqs = lm_requests(np, cfg.vocab_size, LM_REQUESTS, LM_PROMPT, LM_NEW)
    out = serve_lm(torch, np, dev, card, cfg, params, slots=LM_SLOTS,
                   max_len=LM_MAX_LEN, reqs=reqs, label="LM path")
    lm_profiled_ticks(torch, np, out.pop("eng"), cfg.vocab_size,
                      LM_PROMPT[1], LM_NEW[1], "LM profiled window")
    lm_decode_continuity(torch, np, dev, cfg, params, (32, 57), "LM")
    return {"launches": out["k5"], "max_abs_err": out["k5_err"]}


def ssm_path(torch, np, dev, card) -> dict:
    """Phase 13: mamba2-780m at full width: the engine over 24 requests
    whose prompts cross one to four SSD chunks, K5 and K6 held against
    their plain versions; a profiled window of decode ticks; a profiled
    1000-token prefill (beside the parent's K6, with a parent tree);
    the float32 slotted decode against ``forward`` over a prompt that
    spans two chunks."""
    from repro_torch import configs
    cfg = configs.get(SSM_ARCH)
    params = init_lm(torch, dev, cfg)
    reqs = lm_requests(np, cfg.vocab_size, LM_REQUESTS, SSM_PROMPT, LM_NEW)
    out = serve_lm(torch, np, dev, card, cfg, params, slots=LM_SLOTS,
                   max_len=SSM_MAX_LEN, reqs=reqs, label="SSM path")
    eng = out.pop("eng")
    lm_profiled_ticks(torch, np, eng, cfg.vocab_size, SSM_PROMPT[1],
                      LM_NEW[1], "SSM profiled window")
    lm_profiled_prefill(torch, np, eng, cfg.vocab_size, SSM_PROMPT[1],
                        "SSM profiled prefill", parent_k6())
    del eng
    lm_decode_continuity(torch, np, dev, cfg, params, (57, 300), "SSM")
    return out


def hybrid_path(torch, np, dev, card) -> dict:
    """Phase 14: zamba2-1.2b at full width: the engine over 8 requests on 4
    slots, K5 and K6 held against their plain versions."""
    from repro_torch import configs
    cfg = configs.get(HYBRID_ARCH)
    params = init_lm(torch, dev, cfg)
    reqs = lm_requests(np, cfg.vocab_size, HYBRID_REQUESTS, HYBRID_PROMPT,
                       HYBRID_NEW)
    out = serve_lm(torch, np, dev, card, cfg, params, slots=HYBRID_SLOTS,
                   max_len=HYBRID_MAX_LEN, reqs=reqs, label="hybrid path")
    del out["eng"]
    return out


def lm_profiled_ticks(torch, np, eng, vocab: int, prompt: int, budget: int,
                      label: str) -> None:
    """A profiled steady window of the engine: one request per slot, each
    with a ``prompt``-token prompt and a budget of ``budget``, fills every
    slot; three ticks run untraced, then LM_PROFILE_TICKS decode ticks
    (nothing admitted or released) run under torch.profiler (host and
    device): the device's busy share of the host wall time (an upper
    estimate of the idle share, as in phase 6), K5's device time per launch
    and the device time by kernel.  The requests are cancelled afterwards."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 2)
    slots = eng.scfg.max_slots
    rids = [eng.submit(rng.integers(0, vocab, prompt).astype(np.int32),
                       budget) for _ in range(slots)]
    for _ in range(3):
        eng.tick()
    torch.cuda.synchronize()
    ticks = eng.stats()["decode_ticks"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_TICKS):
            eng.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if eng.stats()["decode_ticks"] - ticks != LM_PROFILE_TICKS:
        fail(f"the {label} was not all decode ticks")
    for rid in rids:
        eng.cancel(rid)
    evs = device_events(prof)
    k5 = kernel_device_us(prof, "q15_matmul_kernel")
    if not evs or k5 is None:
        fail(f"{label}: the trace holds no device event of q15_matmul_kernel")
    busy = busy_us(evs)
    by_name = {}
    for e in evs:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"{label} ({LM_PROFILE_TICKS} decode ticks, {slots} active "
          f"slots): host wall {wall_us:.1f} us "
          f"({wall_us / LM_PROFILE_TICKS:.1f} us per tick), device busy "
          f"{busy:.1f} us = {busy / wall_us:.2%}, idle "
          f"{1 - busy / wall_us:.2%}; {len(evs)} device events "
          f"({len(evs) / LM_PROFILE_TICKS:.0f} per tick); q15_matmul_kernel "
          f"{k5[0]} launches x {k5[1]:.3f} us device time")
    print(f"{label} device time by event (count, total us): " +
          "; ".join(f"{k[:60]} {n} {t:.1f}" for k, (n, t) in
                    sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]))


def lm_profiled_prefill(torch, np, eng, vocab: int, prompt: int,
                        label: str, parent=None) -> None:
    """One request of ``prompt`` tokens and a budget of one token (its
    prefill samples it), run once untraced and then under torch.profiler
    (host and device) from its submission, which prefills it into a free
    slot, to its completion: the host wall time, the device's busy share
    and K6's device time, each phase summed over its launches; fails if
    the trace misses a K6 phase.  With ``parent`` (another checkout's K6,
    :func:`parent_k6`), the same prefill is then timed with it in the
    scan's place and with this K6, in turns."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, vocab, prompt).astype(np.int32)

    def prefill() -> float:
        """Host wall ms from submission to completion, device included."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid = eng.submit(toks, 1)        # prefills it into a free slot
        eng.run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        eng.result(rid)
        return wall

    prefill()                            # untraced, to warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us = prefill() * 1e3
    evs = device_events(prof)
    k6 = [kernel_device_us(prof, f"ssd_scan_p{k}_") for k in (1, 2, 3)]
    if not evs or None in k6:
        fail(f"{label}: the trace misses a K6 phase (P1, P2, P3: {k6})")
    busy = busy_us(evs)
    k6_us = sum(n * t for n, t in k6)
    print(f"{label} (one request of {prompt} prompt tokens, budget 1): host "
          f"wall {wall_us:.1f} us, device busy {busy:.1f} us = "
          f"{busy / wall_us:.2%} (idle {1 - busy / wall_us:.2%}), "
          f"{len(evs)} device events; K6 {k6_us:.1f} us of device time "
          f"({k6_us / busy:.2%} of the busy time) over {k6[0][0]} calls: " +
          "; ".join(f"P{k + 1} {ph[1]:.3f} us a launch"
                    for k, ph in enumerate(k6)))
    if parent is None:
        return
    from repro_torch.kernels.ssd_scan import ops
    ours, walls = ops._SCAN, {"parent": [], "K6": []}
    try:
        for _ in range(PREFILL_AB_ROUNDS):
            for who in ("parent", "K6", "K6", "parent"):
                ops._SCAN = parent if who == "parent" else ours
                walls[who].append(prefill())
    finally:
        ops._SCAN = ours
    med = {who: float(np.median(w)) for who, w in walls.items()}
    wins = sum(k < p for k, p in zip(walls["K6"], walls["parent"]))
    print(f"{label}: the same prefill with the parent's K6 in the scan's "
          f"place, in turns parent, K6, K6, parent x {PREFILL_AB_ROUNDS}: "
          f"parent [{', '.join(f'{w:.3f}' for w in walls['parent'])}] ms, "
          f"median {med['parent']:.3f} ms; K6 "
          f"[{', '.join(f'{w:.3f}' for w in walls['K6'])}] ms, median "
          f"{med['K6']:.3f} ms; parent - K6 {med['parent'] - med['K6']:+.3f} "
          f"ms; K6 faster in {wins} of {len(walls['K6'])} pairs")


def cache_rows(cache, slot: int) -> dict:
    """Clones of one slot's rows of every cache tensor (K/V, SSM state,
    conv tails) and of its ``pos``."""
    rows = {n: cache[n][:, slot].clone() for n in ("k", "v", "ssm")
            if cache.get(n) is not None}
    rows.update({f"conv.{n}": t[:, slot].clone()
                 for n, t in cache.get("conv", {}).items()})
    rows["pos"] = cache["pos"][slot].clone()
    return rows


def lm_decode_continuity(torch, np, dev, cfg, params, lens, label) -> None:
    """The full-width weights in float32 (TF32 off): a 4-slot cache, slots
    0 and 2 admitted at ``lens`` prompt tokens, 16 slotted decode ticks
    with slot 2 inactive for the middle 4.  Each decode logit row must be
    within F32_DECODE_ATOL of ``forward`` on the whole sequence, and the
    inactive and empty slots' cache rows (K/V, SSM state, conv tail) and
    ``pos`` must stay bitwise."""
    import dataclasses
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_map

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    steps, idle, slots = 16, range(6, 10), (0, 2)
    rng = np.random.default_rng(SEED + 1)
    seqs = [rng.integers(0, cfg.vocab_size, n + steps) for n in lens]
    cache = T.init_slot_cache(cfg32, 4, max(lens) + steps, dtype=torch.float32,
                              device=dev)
    for slot, seq, n in zip(slots, seqs, lens):
        _, cache = T.prefill_into_slot(
            cfg32, p32, cache, {"tokens": torch.as_tensor(seq[None, :n],
                                                          device=dev)}, slot)
    fed, got = [0, 0], [[], []]
    for t in range(steps):
        active = [True, False, t not in idle, False]
        toks = np.zeros((4, 1), np.int64)
        for j, slot in enumerate(slots):
            if active[slot]:
                toks[slot, 0] = seqs[j][lens[j] + fed[j]]
        keep = {s: cache_rows(cache, s) for s in range(4) if not active[s]}
        logits, cache = T.decode_step_slotted(
            cfg32, p32, cache, torch.as_tensor(toks, device=dev),
            torch.as_tensor(active, device=dev))
        for s, rows in keep.items():
            now = cache_rows(cache, s)
            if not all(torch.equal(now[n].reshape(-1).view(torch.uint8),
                                   v.reshape(-1).view(torch.uint8))
                       for n, v in rows.items()):
                fail(f"{label} f32 slotted decode: inactive slot {s} changed "
                     f"at tick {t}")
        for j, slot in enumerate(slots):
            if active[slot]:
                got[j].append(logits[slot, 0])
                fed[j] += 1
    err = 0.0
    for j in range(2):
        n = lens[j] + fed[j]
        full, _, _ = T.forward(cfg32, p32, {"tokens": torch.as_tensor(
            seqs[j][None, :n], device=dev)})
        e = float((torch.stack(got[j]) - full[0, lens[j]:n]).abs().max())
        if not e <= F32_DECODE_ATOL:
            fail(f"{label} f32 slotted decode vs forward (slot {slots[j]}): "
                 f"max |diff| {e:.3e} > {F32_DECODE_ATOL}")
        err = max(err, e)
    torch.cuda.synchronize()
    print(f"{label} f32 slotted decode at full width: slots {slots} admitted "
          f"at {lens} prompt tokens in a 4-slot cache, {steps} ticks with "
          f"slot 2 inactive for ticks {idle.start}-{idle.stop - 1}: max "
          f"|decode - forward| {err:.3e} <= {F32_DECODE_ATOL} over "
          f"{fed[0] + fed[1]} logit rows of {cfg.vocab_size}; the inactive "
          f"and empty slots' cache rows and pos bitwise unchanged; in "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: L-S-Q on the H100 (train -> IHT -> Q15 PTQ -> calibration -> LUT)
# ---------------------------------------------------------------------------

def adam_card_vs_cpu(torch, np, dev, params, windows, labels) -> None:
    """One ``train_step`` (loss gradient + ``_adam_update`` from a fresh
    state) from the same params and batch on the card and on the CPU: the
    updated params within ADAM_ATOL on every leaf.  The loss and the first
    moment (0.1 x the gradient, whose float32 sums run in another order on
    each device) are printed beside it."""
    from repro_torch.core import pipeline as pl
    xs = torch.from_numpy(np.ascontiguousarray(
        windows[:BATCH_ADAM].transpose(1, 0, 2)))
    ys = torch.from_numpy(labels[:BATCH_ADAM].astype(np.int64))
    runs = []
    for d in (dev, torch.device("cpu")):
        p = {k: v.detach().to(d) for k, v in params.items()}
        new, opt, loss = pl.train_step(p, pl._adam_init(p), xs.to(d),
                                       ys.to(d))
        runs.append((new, opt["m"], float(loss)))
    (card, m_card, l_card), (cpu, m_cpu, l_cpu) = runs
    err = {k: float((v.cpu() - cpu[k]).abs().max()) for k, v in card.items()}
    rel = max(float((v.cpu() - m_cpu[k]).abs().max()
                    / m_cpu[k].abs().max().clamp_min(1e-30))
              for k, v in m_card.items())
    worst = max(err, key=err.get)
    print(f"L-S-Q Adam step, card vs CPU ({BATCH_ADAM} windows, "
          f"{len(params)} leaves): params max |diff| {err[worst]:.3e} at "
          f"{worst}; loss |diff| {abs(l_card - l_cpu):.3e}; "
          f"first moment max |diff| / max |m| {rel:.3e}")
    if err[worst] > ADAM_ATOL:
        fail(f"Adam step on the card vs the CPU: {worst} differs by "
             f"{err[worst]:.3e} > {ADAM_ATOL}")


def lsq_path(torch, np, dev, epochs: int = LSQ_EPOCHS):
    """The paper's L-S-Q pipeline made on the card: ``train_fastgrnn`` on
    ``cuda`` with ``configs.fastgrnn_har`` (r_w = 2, r_u = 8, batch 64, lr
    1e-3, IHT to s = 0.5 ramped over the first half of the epochs) on the
    7,352-window synthetic train split; one Adam step card vs CPU;
    ``default_deploy_pipeline(bits=15, sparsity=0.5)`` on the card and on
    the CPU (identical ``.fgar`` bytes, through a round trip too; 283
    deployed parameters); then phase 7's window path on the trained
    artifact (Table VI, warm-up) and the FP32 / Q15 macro F1.  Returns the
    trained artifact (phase 16 exports it)."""
    from repro_torch.compress import ModelArtifact, default_deploy_pipeline
    from repro_torch.configs import fastgrnn_har as paper
    from repro_torch.core import compression as comp
    from repro_torch.core import pipeline as pl
    from repro_torch.data import hapt
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan

    train = hapt.generate_synthetic("train", SEED)
    iht = comp.IHTConfig(target_sparsity=paper.IHT.target_sparsity,
                         ramp_epochs=epochs // 2,
                         finetune_epochs=epochs - epochs // 2)
    t0 = time.perf_counter()
    res = pl.train_fastgrnn(paper.CELL, train.windows, train.labels,
                            epochs=epochs, batch_size=paper.BATCH_SIZE,
                            lr=paper.LEARNING_RATE, seed=SEED, iht=iht,
                            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = np.asarray(res.step_seconds) * 1e3
    loss = [h["loss"] for h in res.history]
    print(f"L-S-Q train on {dev}: {epochs} epochs (cut from "
          f"{paper.EPOCHS}), {len(ms)} steps of {paper.BATCH_SIZE} over "
          f"{len(train.labels)} windows; ms/step p50 "
          f"{np.percentile(ms, 50):.3f} p99 {np.percentile(ms, 99):.3f}; "
          f"loss epoch 0 {loss[0]:.4f}, epoch {epochs - 1} {loss[-1]:.4f}; "
          f"wall {wall:.1f} s, {paper.EPOCHS} epochs extrapolated "
          f"{wall / epochs * paper.EPOCHS:.1f} s")
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        fail(f"L-S-Q training did not learn: loss {loss}")
    adam_card_vs_cpu(torch, np, dev, res.params, train.windows,
                     train.labels)

    art = default_deploy_pipeline(bits=15, sparsity=0.5, device=dev).run(
        ModelArtifact.from_params(res.params))
    blob = art.to_bytes()
    cpu = default_deploy_pipeline(bits=15, sparsity=0.5, device="cpu").run(
        ModelArtifact.from_params({k: v.cpu() for k, v in
                                   res.params.items()}))
    if cpu.to_bytes() != blob:
        fail("L-S-Q: the .fgar compressed on the card != on the CPU")
    art = ModelArtifact.from_bytes(blob)
    if art.to_bytes() != blob:
        fail("L-S-Q: .fgar round trip changed the bytes")
    nz = comp.deployed_param_count(art.params, art.masks)
    rep = art.size_report()
    print(f"L-S-Q compress ({' -> '.join(art.passes_applied())}): .fgar "
          f"{len(blob)} B, sha256 {art.sha256()}, bitwise equal on the card "
          f"and the CPU and through a round trip; {nz} deployed parameters "
          f"= {2 * nz} B at Q15; weights dense {rep['weight_bytes_dense']} "
          f"B, packed {rep['weight_bytes_packed']} B, sparsity "
          f"{rep['weight_sparsity']:.4f}, total packed "
          f"{rep['total_bytes_packed']} B")
    if nz != PAPER_NONZERO:
        fail(f"L-S-Q: {nz} deployed parameters, want {PAPER_NONZERO}")

    WindowScan.launches = 0             # count this phase's run only
    # On a trained model a few windows' LUT buckets flip between K3's
    # float32 sums and the engine's, as between the reference's own kernel
    # and runtime (tests/test_torch_pipeline.py); the reference holds
    # window 0 to 2e-5 (tests/test_qruntime.py), and so does this phase.
    served = window_path(torch, np, dev, art, label="L-S-Q ", held=1)
    k3 = WindowScan.launches
    print(f"L-S-Q launches: K1 {served['k1']}, K3 {k3}, K4 {served['k4']}")
    if not (served["k1"] and k3 == 1 and served["k4"]):
        fail(f"L-S-Q: the window path launched K1 {served['k1']}, K3 {k3}, "
             f"K4 {served['k4']} times (want > 0, 1, > 0)")
    labels = served["split"].labels
    fp32 = pl.predict_fp32(art.params, served["split"].windows, device=dev)
    q15 = served["p2"]
    f1_fp32, f1_q15 = pl.macro_f1(labels, fp32), pl.macro_f1(labels, q15)
    print(f"L-S-Q macro F1 on {len(labels)} synthetic test windows: FP32 "
          f"{f1_fp32:.4f}, Q15 (K1 engine) {f1_q15:.4f}; Q15/FP32 "
          f"agreement {pl.agreement(q15, fp32):.4%}; accuracy FP32 "
          f"{pl.accuracy(labels, fp32):.4f}, Q15 "
          f"{pl.accuracy(labels, q15):.4f}")
    # the reference's bars for a trained, sparsified, deployed model
    # (tests/test_system.py::test_har_end_to_end_lsq)
    if f1_fp32 <= MIN_LSQ_F1 or pl.agreement(q15, fp32) <= MIN_LSQ_AGREEMENT:
        fail(f"L-S-Q: FP32 macro F1 {f1_fp32:.4f} (want > {MIN_LSQ_F1}) or "
             f"Q15/FP32 agreement {pl.agreement(q15, fp32):.4%} (want > "
             f"{MIN_LSQ_AGREEMENT:.0%})")
    return art


# ---------------------------------------------------------------------------
# phase 16: deploy parity on the card (Sec. VI-B)
# ---------------------------------------------------------------------------

PARITY_BITWISE = ("qruntime_engine_traj", "c_float_engine_logits",
                  "c_float_engine_traj", "c_int_qvm_traces",
                  "c_int_qvm_logits", "c_int_qvm_counters",
                  "numerics_crosscheck")


def golden_replay(np) -> None:
    """The reference's committed fixture, read and never written: its
    image bytes through ``DeployImage.from_bytes``/``to_bytes``, the port's
    qvm and the emitted integer C compiled on the host, all bitwise."""
    import tempfile
    from repro_torch.deploy import QVM, DeployImage, emit_c
    from repro_torch.deploy.goldens import load_goldens

    g = load_goldens(GOLDEN)
    blob = bytes(np.asarray(g["image_bytes"], np.uint8))
    img = DeployImage.from_bytes(blob)
    if len(blob) != GOLDEN_IMAGE_BYTES or img.to_bytes() != blob:
        fail(f"deploy: the fixture's {len(blob)}-byte image does not round "
             f"trip through DeployImage ({GOLDEN_IMAGE_BYTES} B expected)")
    vm = QVM(img)
    n = g["traces"].shape[0]
    lg, traces = vm.run_windows(g["xq"][:n], return_trajectory=True)
    all_lg = vm.run_windows(g["xq"])
    for name, got, want in (("traces", traces, g["traces"]),
                            ("trace_logits", lg, g["trace_logits"]),
                            ("logits", all_lg, g["logits"]),
                            ("preds", np.argmax(all_lg, axis=1), g["preds"])):
        if not np.array_equal(got, want):
            fail(f"deploy: the port's qvm {name} != the fixture's")
    if emit_c.find_cc() is None:
        fail("deploy: no host C compiler (cc, gcc or clang) on PATH")
    with tempfile.TemporaryDirectory() as td:
        cm = emit_c.CHostModel(emit_c.compile_host(img, td, engine="int"),
                               img.H, img.C, engine="int")
        ctr, clg, _ = cm.trace(g["xq"])
    if not (np.array_equal(ctr[:n], g["traces"])
            and np.array_equal(clg, g["logits"])):
        fail("deploy: the emitted int C != the fixture's traces or logits")
    print(f"deploy fixture {os.path.relpath(GOLDEN, ROOT)}: image "
          f"{len(blob)} B round trips, sha256 {g['image_sha256'][:16]}...; "
          f"the port's qvm traces ({n} x {traces.shape[1]} steps), logits "
          f"and preds ({len(g['preds'])} windows) and the emitted int C's "
          f"traces and logits bitwise the fixture's")


@contextlib.contextmanager
def engine_census():
    """Every ``StreamingEngine`` made inside the ``with`` block has its K1
    wrapper's launches zeroed and its library seen through
    :class:`FixedCount`; yields the list of those engines."""
    from repro_torch.serve.streaming import StreamingEngine

    engines, init = [], StreamingEngine.__init__

    def counted(self, *args, **kw):
        init(self, *args, **kw)
        count_fixed([self.kernel.kernel])
        engines.append(self)

    StreamingEngine.__init__ = counted
    try:
        yield engines
    finally:
        StreamingEngine.__init__ = init


def parity_on_card(torch, np, dev, art, windows, label: str) -> dict:
    """``run_parity`` on ``dev``: every ``bitwise`` entry must be true, the
    C paths present, the float C and the scalar subset equal to the K1
    engine on every window, and every engine tick one fixed-width K1
    launch.  Prints the reported (not gated) agreements, sizes, budgets
    and section times."""
    from repro_torch.deploy.verify import quantized_paths_agree, run_parity

    with engine_census() as engines:
        report = run_parity(art, windows=windows, device=dev)
    ticks = sum(e.stats()["ticks"] for e in engines)
    launches, fixed = read_fixed([e.kernel.kernel for e in engines])
    if not engines or launches != ticks or fixed != launches:
        fail(f"deploy {label}: {len(engines)} engines, K1 launches "
             f"{launches}, fixed-width {fixed}, advancing ticks {ticks}")
    missing = {"c_float", "c_int"} - set(report["paths"])
    if missing:
        fail(f"deploy {label}: the C paths {sorted(missing)} did not run")
    bad = [k for k in PARITY_BITWISE if not report["bitwise"].get(k)]
    if bad or set(report["bitwise"]) != set(PARITY_BITWISE):
        fail(f"deploy {label}: bitwise entries failed or missing: {bad}; "
             f"have {report['bitwise']}")
    ag = report["agreement"]
    if ag["c_float_vs_engine"] != 1.0 or \
            ag["qruntime_subset_vs_engine"] != 1.0:
        fail(f"deploy {label}: c_float {ag['c_float_vs_engine']}, scalar "
             f"subset {ag['qruntime_subset_vs_engine']} vs the K1 engine")
    pw = report["pairwise"]
    n = report["n_windows"]
    print(f"deploy {label}: run_parity on {dev} over {n} windows: every "
          f"bitwise entry true ({', '.join(PARITY_BITWISE)}): the K1 "
          f"engine's logits and {report['n_trace']} per-step trajectories "
          f"bit-identical to the emitted float C, the int C to the qvm "
          f"(counters too); c_float_vs_engine 1.0, "
          f"qruntime_subset_vs_engine 1.0 ({report['n_scalar_subset']} "
          f"windows); K1 {launches} launches = engine ticks, fixed-width "
          f"on {fixed}")
    print(f"deploy {label}: reported, not gated: " + "; ".join(
        f"{other}_vs_engine {ag[f'{other}_vs_engine']:.4%} "
        f"({pw[f'engine_vs_{other}']['mismatches']} mismatches)"
        for other in ("qvm", "c_int", "fp32")) +
        f"; quantized_paths_agree {quantized_paths_agree(report)}")
    size = report["size"]
    print(f"deploy {label}: weights {size['weight_bytes']} B, image "
          f"{size['total_bytes']} B; budgets " + "; ".join(
              f"{eng} engine {plat} flash headroom {b['flash_headroom']} B, "
              f"SRAM headroom {b['sram_headroom']} B"
              for eng, by in report["budgets"].items()
              for plat, b in by.items()))
    print(f"deploy {label}: section seconds {json.dumps(report['timings_s'])}"
          f", total {report['total_s']}")
    return report


def deploy_path(torch, np, dev, trained) -> None:
    """Phase 16: the deploy path on the card.  (a) the reference's golden
    fixture replayed through the port's image, qvm and emitted int C; (b)
    the Sec. VI-B protocol (``deploy.verify.run_parity``) on phase 15's
    trained artifact over the 3,399-window synthetic test split, with the
    K1 engine as the oracle; (c) the same on the seed-0 init artifact of
    ``build_reference_artifact`` over DEPLOY_INIT_WINDOWS windows; (d) the
    compress CLI's ``--emit-image`` on the card writes the bytes of
    ``build_image`` of the same artifact made on the CPU."""
    import tempfile
    from repro_torch.compress import ModelArtifact, default_deploy_pipeline
    from repro_torch.core import fastgrnn as fg
    from repro_torch.data import hapt
    from repro_torch.deploy import build_image, build_reference_artifact

    t0 = time.perf_counter()
    golden_replay(np)
    test = hapt.generate_synthetic("test", SEED)
    parity_on_card(torch, np, dev, trained, test.windows, "trained L-S-Q")
    init = build_reference_artifact(seed=SEED, device=dev)
    parity_on_card(torch, np, dev, init, test.windows[:DEPLOY_INIT_WINDOWS],
                   f"seed-{SEED} init")

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "q15.fgrn")
        env = dict(os.environ, PYTHONPATH=SRC)
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.compress", "--preset",
             "q15-deploy", "--seed", str(SEED), "--emit-image", path],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            fail(f"compress CLI --emit-image on the card: {res.stderr}")
        blob = open(path, "rb").read()
    params = fg.init_params(fg.FastGRNNConfig(rank_w=2, rank_u=8),
                            torch.Generator().manual_seed(SEED))
    want = build_image(default_deploy_pipeline(bits=15, device="cpu").run(
        ModelArtifact.from_params(params))).to_bytes()
    if blob != want:
        fail("compress CLI --emit-image on the card != build_image of the "
             "same artifact made on the CPU")
    print(f"deploy: python -m repro_torch.compress --preset q15-deploy "
          f"--emit-image on {dev.type}: {len(blob)} B, equal to build_image "
          f"of the artifact made on the CPU")
    print(f"deploy path (phase 16) wall {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the MoE family at full width (OLMoE-1B-7B)
# ---------------------------------------------------------------------------

def moe_routing(torch, np, dev, router) -> None:
    """One full-width layer's routing (``models.moe.route`` at capacity
    factor 1.25) of MOE_ROUTING_TOKENS float32 tokens from seed SEED, on
    the card and on the CPU: every field bitwise equal."""
    from repro_torch import configs
    from repro_torch.models import moe as M
    cfg = configs.get(MOE_ARCH)
    x = np.random.default_rng(SEED + 2).standard_normal(
        (MOE_ROUTING_TOKENS, cfg.d_model)).astype(np.float32)
    kw = dict(num_experts_global=cfg.num_experts, expert_offset=0,
              e_loc=cfg.num_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    card = M.route({"w": router.float()}, torch.as_tensor(x, device=dev),
                   **kw)
    host = M.route({"w": router.float().cpu()}, torch.as_tensor(x), **kw)
    for name in ("gate_idx", "gate_vals", "idx", "wgt", "filled", "keep",
                 "inverse"):
        got, want = getattr(card, name).cpu(), getattr(host, name)
        if got.is_floating_point():
            got, want = got.view(torch.int32), want.view(torch.int32)
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"MoE routing {name}: the card's differs from the CPU's "
                 f"in {int((got != want).sum())} places")
    if card.cap != host.cap:
        fail(f"MoE routing capacity {card.cap} on the card, {host.cap} on "
             "the CPU")
    print(f"MoE routing of {MOE_ROUTING_TOKENS} float32 tokens through layer "
          f"0's router ({cfg.num_experts} experts, top {cfg.top_k}, capacity "
          f"{card.cap} at factor {cfg.capacity_factor}): top-k experts and "
          f"weights, slot table (idx, wgt, filled), kept assignments and "
          f"inverse map bitwise equal on the card and the CPU; "
          f"{int(card.aux['dropped'])} of {MOE_ROUTING_TOKENS * cfg.top_k} "
          f"assignments dropped")


def moe_path(torch, np, dev, card) -> dict:
    """Phase 17: OLMoE-1B-7B at full width through the engine (K5 at its
    head) and a profiled window of its decode ticks, a prefill run twice
    bitwise with its drops counted, the
    routing on the card against the CPU, then the float32 slotted decode
    against ``forward`` on the first MOE_DECODE_LAYERS layers."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.pytree import tree_map

    t0 = time.perf_counter()
    cfg = configs.get(MOE_ARCH)
    params = init_lm(torch, dev, cfg)
    reqs = lm_requests(np, cfg.vocab_size, MOE_REQUESTS, MOE_PROMPT, MOE_NEW)
    out = serve_lm(torch, np, dev, card, cfg, params, slots=LM_SLOTS,
                   max_len=LM_MAX_LEN, reqs=reqs, label="MoE path")
    eng = out.pop("eng")
    lm_profiled_ticks(torch, np, eng, cfg.vocab_size, MOE_PROMPT[1],
                      MOE_NEW[1], "MoE profiled window")

    toks = max((t for t, _ in reqs), key=len)
    batch = {"tokens": torch.as_tensor(toks[None].astype(np.int64),
                                       device=dev)}
    runs = [T.forward(cfg, eng.params, batch)[:2] for _ in range(2)]
    torch.cuda.synchronize()
    (a, aux), (b, _) = runs
    if not bits_equal(a, b):
        fail("MoE prefill run twice: logits differ "
             f"({first_diff(a[0], b[0])})")
    dropped = int(aux["dropped"])
    total = len(toks) * cfg.top_k * cfg.num_layers
    cap = M.capacity(len(toks), cfg.top_k, cfg.num_experts,
                     cfg.capacity_factor)
    if dropped == 0:
        fail(f"MoE prefill of {len(toks)} tokens dropped no assignment at "
             f"capacity factor {cfg.capacity_factor}")
    print(f"MoE prefill of {len(toks)} tokens through forward on the "
          f"engine's weights, run twice on the card: logits "
          f"{tuple(a.shape)} bitwise equal; {dropped} of {total} (token, "
          f"expert) assignments dropped over {cfg.num_layers} layers at "
          f"capacity factor {cfg.capacity_factor} (capacity {cap} a layer)")
    del eng, runs, a, b
    moe_routing(torch, np, dev, params["blocks"]["moe"]["router"]["w"][0])
    torch.cuda.empty_cache()

    n = MOE_DECODE_LAYERS
    cut = dataclasses.replace(cfg, num_layers=n,
                              capacity_factor=cfg.num_experts / cfg.top_k)
    shallow = dict(params, blocks=tree_map(lambda t: t[:n], params["blocks"]))
    lm_decode_continuity(torch, np, dev, cut, shallow, (32, 57),
                         f"MoE ({n} of {cfg.num_layers} layers, no-drop "
                         f"capacity factor {cut.capacity_factor})")
    del params, shallow
    torch.cuda.empty_cache()
    print(f"MoE path (phase 17) wall {time.perf_counter() - t0:.1f} s")
    return out


def parse_args(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port's paths on one "
                                 "CUDA card (see the module docstring).")
    ap.add_argument("--parent", metavar="TREE",
                    help="also time the K1, K2, K5 and K6 of another "
                         "checkout (e.g. the parent commit unpacked by git "
                         "archive) beside this one's, on the same card")
    return ap.parse_args(argv)


def main() -> int:
    args = parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.data import hapt

    card = environment(torch)
    build(args.parent)
    windows = hapt.generate_synthetic("test", SEED, n=8).windows
    dev = torch.device("cuda", 0)
    max_err = kernel_vs_plain(torch, windows, dev)
    k1_plan(torch, dev)
    k1_edges(torch, dev)
    dense_err = dense_vs_plain(torch, np, dev)
    k2_plan(torch, dev)
    k2_edges(torch, dev)
    lut_err = lut_vs_plain(torch, np, dev)
    window_err = window_vs_plain(torch, np, dev)
    q15_vs_plain(torch, np, dev)
    ssd_vs_plain(torch, np, dev)
    ssd_edges(torch, dev)
    launches, eng, feeds, art, events = main_path(torch, np, dev)
    profiled_window(torch, eng, feeds)
    sw = eng.kernel.sw
    del eng
    single = per_stream(events, [f"s{i}" for i in range(SLOTS + EXTRA)])
    del events
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan
    WindowScan.launches = 0             # count the window path's run only
    k4_launches = window_path(torch, np, dev, art)["k4"]
    window_at_scale(torch, np, dev, art, feeds, single)
    k3_launches = WindowScan.launches
    if k3_launches != 2:
        fail(f"window path launched K3 {k3_launches} times, want 2")
    k2 = fleet_path(torch, np, dev, art, feeds, single, mxu=True)
    fleet_path(torch, np, dev, art, feeds, single, mxu=False)
    del single
    failover(torch, np, dev, art, feeds)
    t = timing(torch, sw, art, args.parent)
    del feeds, art
    lm = lm_path(torch, np, dev, card)
    torch.cuda.empty_cache()
    ssm = ssm_path(torch, np, dev, card)
    torch.cuda.empty_cache()
    hybrid_path(torch, np, dev, card)
    torch.cuda.empty_cache()
    trained = lsq_path(torch, np, dev)
    deploy_path(torch, np, dev, trained)
    del trained
    torch.cuda.empty_cache()
    moe_path(torch, np, dev, card)
    src = "src/repro/kernels/fastgrnn_cell/kernel.py"
    rows = [("q15_step", f"{src}:119", launches, max_err),
            ("q15_step_dense", f"{src}:146", k2["launches"], dense_err),
            ("fastgrnn_window", f"{src}:31", k3_launches, window_err),
            ("lut_act", "src/repro/kernels/lut_act/kernel.py:25",
             k4_launches, lut_err),
            ("q15_matmul", "src/repro/kernels/q15_matmul/kernel.py:26",
             lm["launches"], lm["max_abs_err"]),
            ("ssd_scan", "src/repro/kernels/ssd_scan/kernel.py:23",
             ssm["k6"], ssm["k6_err"])]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": n, "max_abs_err": err, "ms": t[name]["ms"],
        "plain_ms": t[name]["plain_ms"], "bound_ms": t[name]["bound_ms"],
        "bound_by": t[name]["bound_by"], "library_ms": t[name]["library_ms"]}
        for name, replaces, n, err in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
