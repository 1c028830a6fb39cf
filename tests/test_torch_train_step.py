"""Port parity, mirror of ``tests/test_models_smoke.py::
test_reduced_train_step`` over every arch: a reduced float32 config on the
reference's own initialised tree and the reference test's batch; the
port's ``transformer.train_loss`` within 1e-5 relative of the reference's
(its ``ce``, ``aux_loss`` and ``router_z_loss`` too) and every gradient
leaf within 1e-4 x max|g| of ``jax.value_and_grad``'s, the largest
deviation printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch import configs as C
from trainharness import (keyed, port_value_and_grad, reference_setup,
                          smoke_batch)

ARCHS = list(C.ARCHS)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step(arch):
    jcfg, jp, cfg, p = reference_setup(arch)
    b = smoke_batch(cfg)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda q: JT.train_loss(jcfg, q, {k: jnp.asarray(v)
                                          for k, v in b.items()}),
        has_aux=True)(jp)
    loss, met, g = port_value_and_grad(
        cfg, p, {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(loss)), arch
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for name in ("ce", "aux_loss", "router_z_loss"):
        assert abs(float(met[name]) - float(jmet[name])) <= LOSS_RTOL * max(
            abs(float(jmet[name])), 1e-30), name
    got, want = keyed(g), keyed(jax.tree.map(np.asarray, jg))
    assert set(got) == set(want)
    worst, total = 0.0, 0.0
    for name, w in want.items():
        d = got[name].numpy()
        lim = GRAD_REL * float(np.abs(w).max())
        err = float(np.abs(d - w).max())
        assert err <= lim, (arch, name, err, lim)
        worst = max(worst, err / max(float(np.abs(w).max()), 1e-30))
        total += float(np.abs(d).sum())
    assert np.isfinite(total) and total > 0, arch
    print(f"{arch}: loss {float(loss)!r} vs {float(jloss)!r}, largest "
          f"gradient deviation {worst:.3e} x max|g| over {len(want)} leaves")

