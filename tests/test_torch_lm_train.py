"""Port parity, LM training end to end on the CPU: the trainer over
``registry.make_train_step`` and the token stream, the registry's
optimizer stand-ins, and the two launchers.

* The LM half of ``tests/test_system.py::test_lm_trainer_smoke``: reduced
  qwen2 through the port's ``Trainer`` for 30 steps, the loss falls, a
  checkpoint lands at step 30.
* From the reference's float32 init tree, the port's first 5 losses
  within 1e-4 relative of the reference ``Trainer``'s on the same batches.
* ``registry.abstract_opt``'s ``meta`` stand-ins equal to the reference's
  ``jax.eval_shape`` of its optimizer state, for every full config,
  nothing allocated.
* ``python -m repro_torch.launch.train --device cpu --reduced`` and
  ``launch.serve --device cpu --reduced`` (also from that checkpoint) run;
  ``launch.serve`` refuses a vlm naming ROADMAP C6 and an encoder; the
  production meshes are refused naming A10's distributed half; the default device is
  the card, which raises without one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.data import tokens as jtokens
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.train.optimizer import AdamConfig as JAdamConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs as C
from repro_torch import weights
from repro_torch.data import tokens
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.pytree import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = list(C.ARCHS)
F32 = dict(compute_dtype="float32", param_dtype="float32")


def port_batch_fn(tcfg):
    return lambda s: {k: torch.from_numpy(v)
                      for k, v in tokens.lm_batch(tcfg, s).items()}


def test_lm_trainer_smoke(tmp_path):
    """Reduced qwen2 through the port's Trainer: loss falls, checkpoints
    land."""
    cfg = C.reduced(C.get("qwen2-1.5b"))
    tcfg = tokens.TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8)
    acfg = AdamConfig(lr=3e-3, warmup_steps=5)
    tr = Trainer(
        TrainerConfig(total_steps=30, checkpoint_every=10, adam=acfg,
                      checkpoint_dir=str(tmp_path)),
        init_params_fn=lambda: R.init(cfg, torch.Generator().manual_seed(0)),
        step_fn=R.make_train_step(cfg, acfg), batch_fn=port_batch_fn(tcfg))
    hist = tr.run()
    losses = [h["loss"] for h in hist if "loss" in h]
    assert len(losses) == 30
    assert losses[-1] < losses[0]       # it learns the motif structure
    assert ckpt.latest_step(str(tmp_path)) == 30
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    assert set(hist[0]) >= {"step", "time_s", "loss", "ce", "aux_loss",
                            "router_z_loss", "grad_norm", "lr"}


def test_first_losses_match_reference_trainer(tmp_path):
    jcfg = JC.reduced(JC.get("qwen2-1.5b"), **F32)
    cfg = C.reduced(C.get("qwen2-1.5b"), **F32)
    with jax.threefry_partitionable(False):
        jp = JT.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg, jtcfg = tokens.TokenStreamConfig(**kw), \
        jtokens.TokenStreamConfig(**kw)
    akw = dict(lr=3e-3, warmup_steps=2)

    def jbatch(s):
        return {k: jnp.asarray(v) for k, v in jtokens.lm_batch(jtcfg,
                                                               s).items()}
    jhist = JTrainer(
        JTrainerConfig(total_steps=5, checkpoint_every=10,
                       checkpoint_dir=str(tmp_path / "ref"),
                       adam=JAdamConfig(**akw)),
        init_params_fn=lambda: jp,
        step_fn=jax.jit(JR.make_train_step(jcfg, JAdamConfig(**akw))),
        batch_fn=jbatch).run()
    hist = Trainer(
        TrainerConfig(total_steps=5, checkpoint_every=10,
                      checkpoint_dir=str(tmp_path / "port"),
                      adam=AdamConfig(**akw)),
        init_params_fn=lambda: weights.lm_params_from_numpy(np_params,
                                                            "cpu"),
        step_fn=R.make_train_step(cfg, AdamConfig(**akw)),
        batch_fn=port_batch_fn(tcfg)).run()
    got = [h["loss"] for h in hist]
    want = [h["loss"] for h in jhist]
    assert len(got) == len(want) == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def spec_layout(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(spec_layout(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_opt_matches_reference_without_allocating(arch):
    cfg, jcfg = C.get(arch), JC.get(arch)
    for state_dtype in ("float32", "bfloat16"):
        got = R.abstract_opt(cfg, AdamConfig(state_dtype=state_dtype))
        want = JR.abstract_opt(jcfg, JAdamConfig(state_dtype=state_dtype))
        assert spec_layout(got) == spec_layout(want)
        assert all(t.is_meta for t in tree_leaves(got))


def test_launch_train_then_serve_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    hist = launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                              "cpu", "--steps", "3", "--checkpoint-every",
                              "2", "--seq", "16", "--global-batch", "2",
                              "--ckpt-dir", d])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert ckpt.latest_step(d) == 3
    assert "done: loss" in capsys.readouterr().out
    for extra in ([], ["--ckpt-dir", d]):
        out = launch_serve.main(["--arch", "qwen2-1.5b", "--reduced",
                                 "--device", "cpu", "--batch", "2",
                                 "--new-tokens", "3", "--quant-bits", "16",
                                 *extra])
        assert out.shape == (2, 3)
    out = launch_serve.main(["--arch", "mamba2-780m", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--new-tokens", "2"])
    assert out.shape == (2, 2)


def test_launchers_refuse_what_they_cannot_run(tmp_path):
    with pytest.raises(SystemExit, match="C6"):
        launch_serve.main(["--arch", "internvl2-76b", "--reduced",
                           "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        launch_serve.main(["--arch", "hubert-xlarge", "--reduced",
                           "--device", "cpu"])
    with pytest.raises(ValueError, match="no process group"):
        launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                           "cpu", "--mesh", "16x16"])
    import distharness
    with distharness.one_rank_mesh(tmp_path):
        with pytest.raises(ValueError, match="needs 256 ranks; the process "
                                             "group has 1"):
            launch_train.main(["--arch", "qwen2-1.5b", "--reduced",
                               "--device", "cpu", "--mesh", "16x16"])
    with pytest.raises(SystemExit, match="patch"):
        launch_train.main(["--arch", "internvl2-76b", "--reduced",
                           "--device", "cpu"])
    if not torch.cuda.is_available():
        for main in (launch_train.main, launch_serve.main):
            with pytest.raises(RuntimeError, match="cuda"):
                main(["--arch", "qwen2-1.5b", "--reduced",
                      "--ckpt-dir", str(tmp_path)])
