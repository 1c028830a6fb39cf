"""Port parity, the L-S-Q pipeline: ``repro_torch.core.pipeline`` against
the reference ``repro.core.pipeline``.  One loss gradient + Adam step
within 1e-6 of the reference's jitted step, a 2-epoch IHT training run
from the reference's initial parameters within 1e-6, and the FastGRNN half
of ``tests/test_system.py`` on the reference's ``trained_har`` parameters
carried across (283 nonzero, deploy predictions bitwise the reference
runtime's, agreement, warm-up statistics)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import fastgrnn as jfg
from repro.core import pipeline as jpl
from repro.core import warmup as jwarmup
from repro_torch.core import compression as comp
from repro_torch.core import fastgrnn as fg
from repro_torch.core import pipeline as pl
from repro_torch.core import warmup
from repro_torch.data import hapt

ADAM_ATOL = 1e-6      # one step: XLA fuses the jitted step into FMAs
TRAIN_ATOL = 1e-6     # 2 epochs x 4 steps from the same start
CFG = dict(rank_w=2, rank_u=8)


def ref_init(seed=0):
    """The reference's initial parameters (threefry, C0's setting)."""
    with jax.threefry_partitionable(False):
        return jfg.init_params(jfg.FastGRNNConfig(**CFG),
                               jax.random.PRNGKey(seed))


def as_torch(p):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in p.items()}


def max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(autouse=True)
def one_thread():
    """The cell's ops are tiny: one intra-op thread is several times faster
    than many under a parallel test run, and gives the same bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    tr = hapt.load("train", n=64)
    return np.ascontiguousarray(np.transpose(tr.windows, (1, 0, 2))), tr.labels


@pytest.mark.parametrize("state", ["fresh", "warm"])
def test_loss_grad_and_adam_step_match_reference(batch, state):
    xs, ys = batch
    jp = ref_init()
    jopt = jpl._adam_init(jp)
    if state == "warm":     # a state seven steps in: the bias corrections bite
        rng = np.random.default_rng(1)
        jopt = {"m": {k: jnp.asarray((1e-3 * rng.standard_normal(
                    np.shape(v))).astype(np.float32)) for k, v in jp.items()},
                "v": {k: jnp.asarray((1e-6 * rng.random(
                    np.shape(v))).astype(np.float32)) for k, v in jp.items()},
                "t": jnp.asarray(7, jnp.int32)}

    @jax.jit
    def jstep(params, opt, xs, ys):
        loss, grads = jax.value_and_grad(jfg.loss_fn)(params, xs, ys)
        params, opt = jpl._adam_update(params, grads, opt)
        return params, opt, loss, grads

    jnew, jnopt, jloss, jgrads = jstep(jp, jopt, jnp.asarray(xs),
                                       jnp.asarray(ys))
    p = as_torch(jp)
    opt = {"m": as_torch(jopt["m"]), "v": as_torch(jopt["v"]),
           "t": torch.tensor(int(jopt["t"]), dtype=torch.int32)}
    loss, grads = pl._value_and_grad(p, torch.from_numpy(xs),
                                     torch.from_numpy(ys.astype(np.int64)))
    with torch.no_grad():
        new, nopt = pl._adam_update(p, grads, opt)
    assert abs(float(loss) - float(jloss)) <= ADAM_ATOL
    assert int(nopt["t"]) == int(jnopt["t"])
    for k in jp:
        assert grads[k].shape == jgrads[k].shape
        assert max_diff(grads[k], jgrads[k]) <= ADAM_ATOL, k
        assert max_diff(new[k], jnew[k]) <= ADAM_ATOL, k
        assert max_diff(nopt["m"][k], jnopt["m"][k]) <= ADAM_ATOL, k
        assert max_diff(nopt["v"][k], jnopt["v"][k]) <= ADAM_ATOL, k


def test_two_epoch_iht_training_matches_reference(monkeypatch):
    """256 windows, 2 epochs x 4 steps, IHT ramping to s = 0.5 at epoch 1,
    from the reference's initial parameters: the port's params within
    TRAIN_ATOL of the reference's, and its masks equal wherever the
    reference's magnitude at mask time lies farther than TRAIN_ATOL from
    the keep threshold."""
    tr = hapt.load("train", n=256)
    jp = ref_init()
    monkeypatch.setattr(fg, "init_params", lambda cfg, gen: as_torch(jp))
    seen, jseen = [], []
    res = pl.train_fastgrnn(
        fg.FastGRNNConfig(**CFG), tr.windows, tr.labels, epochs=2,
        iht=comp.IHTConfig(target_sparsity=0.5, ramp_epochs=1),
        eval_fn=lambda p: seen.append(dict(p)) or {}, eval_every=1,
        device="cpu")
    with jax.threefry_partitionable(False):
        jres = jpl.train_fastgrnn(
            jfg.FastGRNNConfig(**CFG), tr.windows, tr.labels, epochs=2,
            iht=jcomp.IHTConfig(target_sparsity=0.5, ramp_epochs=1),
            eval_fn=lambda p: jseen.append(dict(p)) or {}, eval_every=1)
    assert len(res.step_seconds) == 8
    for h, jh in zip(res.history, jres.history):
        assert h["epoch"] == jh["epoch"]
        assert abs(h["loss"] - jh["loss"]) <= TRAIN_ATOL
    for k in jp:
        assert max_diff(res.params[k], jres.params[k]) <= TRAIN_ATOL, k
    # the final masks were computed at epoch 1 from the params epoch 0 left
    for k in ("W1", "W2", "U1", "U2"):
        mag = np.abs(np.asarray(jseen[0][k])).reshape(-1)
        keep = int(round(mag.size * 0.5))
        thresh = np.sort(mag)[::-1][keep - 1]
        clear = np.abs(mag - thresh) > TRAIN_ATOL
        got = res.masks[k].numpy().reshape(-1)
        want = np.asarray(jres.masks[k]).reshape(-1)
        assert clear.sum() >= mag.size - 2
        np.testing.assert_array_equal(got[clear], want[clear], err_msg=k)
        assert got.sum() == want.sum() == keep
        assert max_diff(seen[0][k], jseen[0][k]) <= TRAIN_ATOL


# ---------------------------------------------------------------------------
# the FastGRNN half of tests/test_system.py, on trained_har's params
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(trained_har):
    cfg, params, tr, te = trained_har
    return {k: np.array(v, np.float32) for k, v in params.items()}, tr, te


def test_har_end_to_end_lsq(trained):
    params, tr, te = trained
    pred = pl.predict_fp32(params, te.windows, device="cpu")
    jpred = jpl.predict_fp32(params, te.windows)
    f1 = pl.macro_f1(te.labels, pred)
    assert f1 > 0.5, f1
    # float32 sums in another order may flip a near tie (1.0 here)
    assert pl.agreement(pred, jpred) >= 0.99
    assert pl.per_class_f1(te.labels, pred) == \
        jpl.per_class_f1(te.labels, pred)
    assert pl.macro_f1(te.labels, pred) == jpl.macro_f1(te.labels, pred)
    assert pl.accuracy(te.labels, pred) == jpl.accuracy(te.labels, pred)

    # sparsify (S stage) and deploy (Q stage)
    tp = as_torch(params)
    masks = comp.compute_masks(tp, comp.IHTConfig(target_sparsity=0.5), 0.5)
    jmasks = jcomp.compute_masks(params, jcomp.IHTConfig(target_sparsity=0.5),
                                 0.5)
    for k in masks:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(jmasks[k]))
    sparse = comp.apply_masks(tp, masks)
    assert comp.deployed_param_count(tp, masks) == 283
    rt = pl.deploy(sparse, tr.windows[:5], device="cpu")
    jrt = jpl.deploy({k: v.numpy() for k, v in sparse.items()},
                     tr.windows[:5])
    windows = te.windows[:200]
    logits = np.stack([rt.run_window(w) for w in windows])
    jlogits = np.stack([jrt.run_window(w) for w in windows])
    np.testing.assert_array_equal(logits.view(np.int32),
                                  jlogits.view(np.int32))
    qpred = rt.predict_batch(windows)
    np.testing.assert_array_equal(qpred, np.argmax(jlogits, axis=1))
    fpred = pl.predict_fp32(sparse, windows, device="cpu")
    agree = pl.agreement(qpred, fpred)
    assert agree > 0.95, agree          # paper: 99.91-100%


def test_warmup_characterization_matches_reference(trained):
    params, tr, te = trained
    rt = pl.deploy(params, tr.windows[:5], device="cpu")
    jrt = jpl.deploy(params, tr.windows[:5])
    preds, jpreds = [], []
    for w in te.windows[:30]:
        _, traj = rt.run_window(w, return_trajectory=True)
        _, jtraj = jrt.run_window(w, return_trajectory=True)
        np.testing.assert_array_equal(traj.view(np.int32),
                                      np.asarray(jtraj).view(np.int32))
        step_logits = traj @ rt._w["head_w"] + rt._head_b
        preds.append(np.argmax(step_logits, axis=-1))
        jstep = jtraj @ np.asarray(jrt._w["head_w"]) + np.asarray(jrt._head_b)
        jpreds.append(np.argmax(jstep, axis=-1))
    stats = warmup.characterize(np.stack(preds))
    assert 1 <= stats.median_samples <= 128
    assert stats.worst_case <= 128
    assert stats.iqr_lo <= stats.median_samples <= stats.iqr_hi
    jstats = jwarmup.characterize(np.stack(jpreds))
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)


def test_window_scan_bucket_flips_are_the_references_own(trained):
    """On the trained, sparsified, deployed model a few of the first 100
    test windows' trajectories leave 2e-5 of the scalar runtime's: a LUT
    bucket flips between the float32 window scan's sums and the
    runtime's.  The port's plain window scan (K3's plain version) flips on
    the same windows by the same amount as the reference's Pallas kernel
    (interpret), and window 0 stays within 2e-5, the reference's bound
    (tests/test_qruntime.py)."""
    from repro.kernels.fastgrnn_cell.ops import fastgrnn_window_kernel as jwin
    from repro_torch.kernels.fastgrnn_cell.kernel import WindowScan
    params, tr, te = trained
    jmasks = jcomp.compute_masks(params, jcomp.IHTConfig(target_sparsity=0.5),
                                 0.5)
    sparse = {k: np.asarray(v) for k, v in
              jcomp.apply_masks(params, jmasks).items()}
    windows = te.windows[:100]
    xs = np.ascontiguousarray(np.transpose(windows, (1, 0, 2)))
    rt = pl.deploy(sparse, tr.windows[:5], device="cpu")
    jrt = jpl.deploy(sparse, tr.windows[:5])
    _, traj = WindowScan(rt.qp.dequantize(), torch.device("cpu")).plain(
        torch.from_numpy(xs))
    _, jtraj = jwin(jrt.qp.dequantize(), jnp.asarray(xs))
    err, jerr = [], []
    for i, w in enumerate(windows):
        _, t = rt.run_window(w, return_trajectory=True)
        _, jt = jrt.run_window(w, return_trajectory=True)
        err.append(np.abs(t - traj[:, i].numpy()).max())
        jerr.append(np.abs(np.asarray(jt) - np.asarray(jtraj)[:, i]).max())
    err, jerr = np.array(err), np.array(jerr)
    assert err[0] <= 2e-5 and jerr[0] <= 2e-5
    flipped = np.nonzero(err > 2e-5)[0]
    np.testing.assert_array_equal(flipped, np.nonzero(jerr > 2e-5)[0])
    assert len(flipped) >= 1            # window 22 here, 1.2e-3 in both
    np.testing.assert_allclose(err[flipped], jerr[flipped], rtol=0.05)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_entry_points_raise_without_a_card():
    tr = hapt.load("train", n=64)
    with pytest.raises(RuntimeError, match="cuda"):
        pl.train_fastgrnn(fg.FastGRNNConfig(**CFG), tr.windows, tr.labels,
                          epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        pl.predict_fp32(as_torch(ref_init()), tr.windows)
