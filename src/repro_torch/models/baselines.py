"""Paper Table IV baselines (reference ``repro.models.baselines``): the
MLP (measured), and the LSTM and GRU cells (theoretical parameter counts
at H=16, d=3; also runnable for the warm-up comparison the paper lists as
future work).

The initialisers draw from a ``torch.Generator`` on its device; they
cannot reproduce JAX's PRNG, so parity tests carry the reference's
parameters across.  ``rnn_run`` is a Python loop over time in place of
``lax.scan``.
"""
from __future__ import annotations

import torch


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return 0.1 * torch.randn(shape, generator=generator,
                             device=generator.device)


def _zeros(generator: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros((n,), device=generator.device)


# ---------------------------------------------------------------------------
# MLP baseline: flatten(128x3=384) -> 32 relu -> 6.
# Params: 384*32+32 + 32*6+6 = 12,518 (Table IV).
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, window: int = 128, d: int = 3,
             hidden: int = 32, classes: int = 6) -> dict:
    return {"w1": _normal(generator, (window * d, hidden)),
            "b1": _zeros(generator, hidden),
            "w2": _normal(generator, (hidden, classes)),
            "b2": _zeros(generator, classes)}


def mlp_forward(params, xs):
    """xs: (T, B, d) window -> (B, C) logits."""
    x = xs.permute(1, 0, 2).reshape(xs.shape[1], -1)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params, xs, labels):
    logp = torch.log_softmax(mlp_forward(params, xs), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def mlp_param_count(window: int = 128, d: int = 3, hidden: int = 32,
                    classes: int = 6) -> int:
    return window * d * hidden + hidden + hidden * classes + classes


# ---------------------------------------------------------------------------
# LSTM / GRU cells (H=16, d=3): Table IV theoretical counts 1280 / 960.
# ---------------------------------------------------------------------------

def _gates_init(generator, gates, d: int, H: int) -> dict:
    p = {}
    for gate in gates:
        p[f"W_{gate}"] = _normal(generator, (H, d))
        p[f"U_{gate}"] = _normal(generator, (H, H))
        p[f"b_{gate}"] = _zeros(generator, H)
    return p


def lstm_init(generator: torch.Generator, d: int = 3, H: int = 16) -> dict:
    return _gates_init(generator, ("i", "f", "g", "o"), d, H)


def lstm_step(p, carry, x):
    h, c = carry
    gates = {g: x @ p[f"W_{g}"].T + h @ p[f"U_{g}"].T + p[f"b_{g}"]
             for g in ("i", "f", "g", "o")}
    i, f = torch.sigmoid(gates["i"]), torch.sigmoid(gates["f"])
    g_, o = torch.tanh(gates["g"]), torch.sigmoid(gates["o"])
    c = f * c + i * g_
    h = o * torch.tanh(c)
    return (h, c), h


def lstm_param_count(d: int = 3, H: int = 16) -> int:
    return 4 * (H * d + H * H) + 4 * H   # 1,280 at H=16, d=3


def gru_init(generator: torch.Generator, d: int = 3, H: int = 16) -> dict:
    return _gates_init(generator, ("r", "z", "n"), d, H)


def gru_step(p, h, x):
    r = torch.sigmoid(x @ p["W_r"].T + h @ p["U_r"].T + p["b_r"])
    z = torch.sigmoid(x @ p["W_z"].T + h @ p["U_z"].T + p["b_z"])
    n = torch.tanh(x @ p["W_n"].T + r * (h @ p["U_n"].T) + p["b_n"])
    return (1 - z) * n + z * h, None


def gru_param_count(d: int = 3, H: int = 16) -> int:
    return 3 * (H * d + H * H) + 3 * H   # 960 at H=16, d=3


def rnn_run(step_fn, params, xs, carry0):
    """Drive ``step_fn`` over xs (T, ...) from ``carry0``; returns the
    (T, ..., H) hidden trajectory."""
    carry, traj = carry0, []
    for x in xs:
        carry, out = step_fn(params, carry, x)
        traj.append(out if out is not None else
                    (carry[0] if isinstance(carry, tuple) else carry))
    return torch.stack(traj)
