"""Mixture-of-Experts layer (reference ``repro.models.moe``): top-k routing,
a capacity-limited token gather per expert, the expert FFN as batched
matmuls, and an atomics-free combine.

* **Routing.** The router's product, softmax and top-k run in float64 and
  the weights are rounded once to float32.  The reference routes in
  float32; a float32 product sums in a different order on the card
  (cuBLAS) and on the CPU, so its weights' bits, and at a near tie the
  chosen experts, would depend on the device.  In float64 the two devices
  differ by ~1e-16 relative, far below a float32 rounding step, so the
  routing is one function wherever it runs, and it stays within float32
  rounding of the reference's.  TF32 never touches a float64 product.
  Top-k is a stable descending sort: values in descending order, ties to
  the lower expert id, as ``jax.lax.top_k`` orders them.
* **Dispatch.** Each (token, expert) assignment's slot in its expert is
  its rank in token-major (n*k) order, the reference's one-hot cumsum; an
  assignment ranked at or past the capacity (:func:`capacity`, Python's
  round) is dropped, which token that is being part of the function.
  Unfilled slots hold token 0 with weight 0, as in the reference.
* **Combine.** The reference scatter-adds each slot's weighted row into
  its token.  On CUDA a scatter-add (``index_add_``, ``scatter_add_``,
  ``index_put_(accumulate=True)``) is a float atomic whose sum order
  changes from run to run.  Here each token gathers its kept slots
  through the inverse map (token, k) -> expert * cap + slot and adds them
  in ascending (expert, slot) order, starting from zero: a gather and a
  fixed-order sum, bitwise the same on every run.
* **Sharding.** ``expert_offset`` and ``num_experts_global`` are kept so
  that the model axis (ROADMAP A10) can give each card its slice of the
  experts; there is no collective here.

Besides the reference's ``aux_loss`` and ``router_z_loss`` the aux dict
carries ``dropped``: the number of this shard's assignments that found
their expert full (an int64 count; 0 whenever the capacity covers every
token, as in serving's decode).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import layers as L


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, kind: str = "swiglu",
             dtype=torch.float32) -> dict:
    """``{"router", "w_in", "w_out"}`` (+ ``"w_gate"`` for the gated
    kinds): the router a float32 dense layer, each expert weight
    ``(E, d_in, d_out)`` in ``dtype`` drawn at std ``1/sqrt(d_in)`` (a
    Python float, so ``dtype`` is kept, unlike the dense layers' C2
    promotion)."""
    def ex(d_in, d_out):
        return L.truncated_normal(generator, (num_experts, d_in, d_out),
                                  1.0 / (d_in ** 0.5), dtype)
    p = {"router": L.dense_init(generator, d_model, num_experts,
                                dtype=torch.float32),
         "w_in": ex(d_model, d_ff),
         "w_out": ex(d_ff, d_model)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = ex(d_model, d_ff)
    return p


def capacity(n_tokens: int, top_k: int, num_experts: int, cf: float) -> int:
    """Slots per expert: ``cf * n * k / E`` rounded by Python's ``round``
    (half to even: 12.5 -> 12), at least ``top_k``."""
    return int(max(top_k, round(cf * n_tokens * top_k / num_experts)))


@dataclasses.dataclass
class Routing:
    """One layer's routing of ``n`` tokens over a shard's ``E_loc``
    experts."""
    gate_idx: torch.Tensor   # (n, k) int64 global expert ids, by weight
    gate_vals: torch.Tensor  # (n, k) float32 weights, summing to 1
    cap: int                 # slots per expert
    idx: torch.Tensor        # (E_loc, cap) int64 token of each slot
    wgt: torch.Tensor        # (E_loc, cap) float32 weight of each slot
    filled: torch.Tensor     # (E_loc, cap) bool
    keep: torch.Tensor       # (n * k,) bool: this shard's, within capacity
    inverse: torch.Tensor    # (n, k) int64 flat slot e * cap + c of each
    #                          kept assignment, ascending; E_loc * cap
    #                          (a zero row) for the others
    aux: dict                # aux_loss, router_z_loss, dropped


def route(router: dict, xt: torch.Tensor, *, num_experts_global: int,
          expert_offset: int, e_loc: int, top_k: int,
          capacity_factor: float) -> Routing:
    """Route ``xt`` ((n, D) tokens) with the ``router`` dense layer (see
    the module docstring for the float64 product)."""
    n = xt.shape[0]
    dev = xt.device
    logits = L.dense_apply(router, xt, compute_dtype=torch.float64)
    probs = torch.softmax(logits, dim=-1)                       # (n, E)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_idx, vals = order[:, :top_k], vals[:, :top_k]
    gate_vals = (vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)).float()

    # aux losses (global-expert statistics, local tokens); integer counts,
    # so no float atomics: each expert's count is the width of its run in
    # the sorted expert ids (bincount's counts, with a shape that does not
    # depend on the values)
    me = probs.mean(0)
    ids = torch.sort(gate_idx.reshape(-1)).values
    edges = torch.searchsorted(ids, torch.arange(
        num_experts_global + 1, dtype=ids.dtype, device=ids.device))
    ce = (edges[1:] - edges[:-1]).double() / (n * top_k)
    aux_loss = (num_experts_global * (me * ce).sum()).float()
    z_loss = torch.logsumexp(logits, -1).square().mean().float()

    # ---- the shard's capacity-limited slot table ------------------------
    cap = capacity(n, top_k, num_experts_global, capacity_factor)
    rel = gate_idx.reshape(-1) - expert_offset                   # (n*k,)
    mine = (rel >= 0) & (rel < e_loc)
    onehot = F.one_hot(torch.where(mine, rel, e_loc), e_loc + 1)[:, :e_loc]
    rank = torch.cumsum(onehot, dim=0) - onehot                  # slot rank
    slot = (rank * onehot).sum(1)                                # (n*k,)
    keep = mine & (slot < cap)
    oob = e_loc * cap                          # one spare entry, then cut
    flat = torch.where(keep, rel * cap + slot, oob)
    token = torch.arange(n, device=dev).repeat_interleave(top_k)

    def table(fill, dtype):
        t = torch.zeros(oob + 1, dtype=dtype, device=dev)
        t[flat] = fill.to(dtype)      # kept entries are distinct; the rest
        return t[:oob].reshape(e_loc, cap)    # land in the spare, cut here
    inverse, _ = torch.sort(flat.reshape(n, top_k), dim=-1)
    return Routing(
        gate_idx=gate_idx, gate_vals=gate_vals, cap=cap,
        idx=table(token, torch.int64),
        wgt=table(torch.where(keep, gate_vals.reshape(-1), 0.0),
                  torch.float32),
        filled=table(keep, torch.bool), keep=keep, inverse=inverse,
        aux={"aux_loss": aux_loss, "router_z_loss": z_loss,
             "dropped": (mine & ~keep).sum()})


def _expert_ffn(p: dict, xe: torch.Tensor, kind: str, cd) -> torch.Tensor:
    """(E, C, D) gathered rows -> (E, C, D), every product in ``cd``."""
    h = torch.bmm(xe, p["w_in"].to(cd))
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else L._gelu
        h = act(torch.bmm(xe, p["w_gate"].to(cd))) * h
    elif kind == "relu2":
        h = torch.square(torch.relu(h))
    else:
        h = L._gelu(h)
    return torch.bmm(h, p["w_out"].to(cd))


def moe_apply_local(p_local: dict, x: torch.Tensor, *,
                    num_experts_global: int, expert_offset: int = 0,
                    top_k: int, capacity_factor: float = 1.25,
                    kind: str = "swiglu", compute_dtype=torch.bfloat16):
    """x: (B, S, D) tokens -> ``(y (B, S, D) in x.dtype, aux)``.

    ``p_local``: expert weights with leading dim E_loc (this shard's
    experts, the first of which is global expert ``expert_offset``); the
    router spans all ``num_experts_global`` experts.  ``y`` holds this
    shard's experts' share of each token's output."""
    b, s, d = x.shape
    e_loc = p_local["w_in"].shape[0]
    n = b * s
    cd = compute_dtype
    xt = x.reshape(n, d)
    r = route(p_local["router"], xt, num_experts_global=num_experts_global,
              expert_offset=expert_offset, e_loc=e_loc, top_k=top_k,
              capacity_factor=capacity_factor)

    xe = xt[r.idx].to(cd) * r.filled[..., None].to(cd)          # (E, C, D)
    ye = _expert_ffn(p_local, xe, kind, cd) * r.wgt[..., None].to(cd)
    rows = torch.cat([ye.reshape(e_loc * r.cap, d),
                      torch.zeros((1, d), dtype=cd, device=x.device)])
    y = torch.zeros((n, d), dtype=cd, device=x.device)
    for j in range(top_k):          # fixed order: ascending (expert, slot)
        y = y + rows[r.inverse[:, j]]
    return y.reshape(b, s, d).to(x.dtype), r.aux


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, kind: str = "swiglu",
              compute_dtype=torch.bfloat16):
    """Single-device path: every expert local."""
    return moe_apply_local(
        p, x, num_experts_global=p["w_in"].shape[0], expert_offset=0,
        top_k=top_k, capacity_factor=capacity_factor, kind=kind,
        compute_dtype=compute_dtype)
