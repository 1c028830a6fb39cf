"""FastGRNN cell (Kusupati et al., NeurIPS'18) — paper Eq. (1)-(3).

z_t   = sigma(W x_t + U h_{t-1} + b_z)
h~_t  = tanh (W x_t + U h_{t-1} + b_h)
h_t   = (zeta * (1 - z_t) + nu) * h~_t + z_t * h_{t-1}

The weight pair (W, U) is shared between the gate and the candidate.
zeta, nu in (0,1) are learned scalars, parameterized as sigmoid(raw).
Low rank (paper Sec. III-B): W = W1 @ W2^T (W1: HxRw, W2: dxRw),
U = U1 @ U2^T (U1, U2: HxRu); full-rank cells store W, U directly.

Parameters are a dict of float32 tensors (the reference's pytree layout)
and every function runs on the device of its inputs.  The small products
go to ``torch.matmul``, as the reference leaves them to XLA; on the card
they stay in full float32 as long as TF32 is off for matmuls (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class FastGRNNConfig:
    input_dim: int = 3          # d — tri-axial acceleration
    hidden_dim: int = 16        # H
    num_classes: int = 6
    rank_w: int | None = None   # r_w; None = full rank
    rank_u: int | None = None   # r_u; None = full rank
    # paper Sec. VI-E future direction 1: U_eff = LowRank(r_u) + diag(alpha)
    diag_residual: bool = False
    zeta_init: float = 1.0      # raw (pre-sigmoid) init, EdgeML default
    nu_init: float = -4.0       # raw (pre-sigmoid) init, EdgeML default

    @property
    def low_rank(self) -> bool:
        return self.rank_w is not None or self.rank_u is not None

    def cell_param_count(self) -> int:
        """Paper Eq. (4) for full rank; factored count for low rank."""
        d, H = self.input_dim, self.hidden_dim
        n_w = H * d if self.rank_w is None else H * self.rank_w + d * self.rank_w
        n_u = H * H if self.rank_u is None else 2 * H * self.rank_u
        if self.diag_residual:
            n_u += H
        return n_w + n_u + 2 * H + 2  # + b_z, b_h, zeta, nu

    def head_param_count(self) -> int:
        return self.hidden_dim * self.num_classes + self.num_classes


def init_params(cfg: FastGRNNConfig,
                generator: torch.Generator) -> dict[str, torch.Tensor]:
    """FastGRNN + dense classifier-head parameters with the reference's
    shapes and scales: N(0, 0.1) factor and head matrices, ``b_z = 1``,
    ``b_h = 0``, raw ``zeta``/``nu`` from ``cfg``, ``alpha = 0.1``, on the
    generator's device."""
    d, H = cfg.input_dim, cfg.hidden_dim
    dev = generator.device

    def mat(*shape):
        return 0.1 * torch.randn(shape, generator=generator, device=dev)

    p: dict[str, torch.Tensor] = {}
    if cfg.rank_w is None:
        p["W"] = mat(H, d)
    else:
        p["W1"] = mat(H, cfg.rank_w)
        p["W2"] = mat(d, cfg.rank_w)
    if cfg.rank_u is None:
        p["U"] = mat(H, H)
    else:
        p["U1"] = mat(H, cfg.rank_u)
        p["U2"] = mat(H, cfg.rank_u)
    if cfg.diag_residual:
        p["alpha"] = torch.full((H,), 0.1, device=dev)
    p["b_z"] = torch.ones(H, device=dev)
    p["b_h"] = torch.zeros(H, device=dev)
    p["zeta"] = torch.tensor(cfg.zeta_init, device=dev)
    p["nu"] = torch.tensor(cfg.nu_init, device=dev)
    p["head_w"] = mat(H, cfg.num_classes)
    p["head_b"] = torch.zeros(cfg.num_classes, device=dev)
    return p


def effective_W(params: dict[str, Any]) -> torch.Tensor:
    if "W" in params:
        return params["W"]
    return params["W1"] @ params["W2"].T


def effective_U(params: dict[str, Any]) -> torch.Tensor:
    u = params["U"] if "U" in params else params["U1"] @ params["U2"].T
    if "alpha" in params:
        u = u + torch.diag(params["alpha"])
    return u


def cell_step(params: dict[str, Any], h: torch.Tensor, x: torch.Tensor, *,
              sigma=torch.sigmoid, tanh=torch.tanh) -> torch.Tensor:
    """One FastGRNN step.  h: (..., H), x: (..., d).  ``sigma``/``tanh``
    are injectable so the LUT activations share this definition."""
    if "W" in params:
        wx = x @ params["W"].T
    else:
        wx = (x @ params["W2"]) @ params["W1"].T  # W1 (W2^T x): 2 thin matmuls
    if "U" in params:
        uh = h @ params["U"].T
    else:
        uh = (h @ params["U2"]) @ params["U1"].T
    if "alpha" in params:
        uh = uh + params["alpha"] * h      # diagonal residual (Sec. VI-E)
    pre = wx + uh
    z = sigma(pre + params["b_z"])
    h_tilde = tanh(pre + params["b_h"])
    zeta = torch.sigmoid(params["zeta"])
    nu = torch.sigmoid(params["nu"])
    return (zeta * (1.0 - z) + nu) * h_tilde + z * h


def run_sequence(params: dict[str, Any], xs: torch.Tensor,
                 h0: torch.Tensor | None = None, *, sigma=torch.sigmoid,
                 tanh=torch.tanh, return_trajectory: bool = False):
    """Run a full window.  xs: (T, ..., d) time-major.  Returns the final
    h (and the (T, ..., H) trajectory if requested)."""
    H = params["b_z"].shape[0]
    h = h0 if h0 is not None else torch.zeros(
        xs.shape[1:-1] + (H,), dtype=xs.dtype, device=xs.device)
    traj = []
    for t in range(xs.shape[0]):
        h = cell_step(params, h, xs[t], sigma=sigma, tanh=tanh)
        if return_trajectory:
            traj.append(h)
    if return_trajectory:
        return h, torch.stack(traj)
    return h


def logits_from_hidden(params: dict[str, Any], h: torch.Tensor) -> torch.Tensor:
    return h @ params["head_w"] + params["head_b"]


def forward_window(params, xs, **kw) -> torch.Tensor:
    """(T, ..., d) window -> (..., C) logits from the final hidden state."""
    return logits_from_hidden(params, run_sequence(params, xs, **kw))


def loss_fn(params, xs, labels, **kw) -> torch.Tensor:
    """Cross-entropy over windows.  xs: (T, B, d), labels: (B,)."""
    logp = F.log_softmax(forward_window(params, xs, **kw), dim=-1)
    return -logp.gather(-1, labels[:, None]).squeeze(-1).mean()


def count_params(params: dict[str, Any]) -> int:
    return int(sum(v.numel() for v in params.values()))


def count_nonzero(params: dict[str, Any]) -> int:
    return int(sum(int(torch.count_nonzero(v)) for v in params.values()))
