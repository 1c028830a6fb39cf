"""Port parity, the LM's training loss and its gradient: the
FlashAttention-2 backward of ``models.attention.chunked_attention`` and
``models.transformer.train_loss`` for every arch.

* ``chunked_attention``: dq, dk and dv within 1e-5 of ``jax.grad``
  through the reference's ``custom_vjp``, causal, windowed and
  bidirectional, with Sq and Sk not multiples of the chunks; its forward
  under ``no_grad`` bitwise the forward-only version it replaced (copied
  below), float32 and bfloat16; the tensors it saves for the backward
  exactly (q, k, v, out, lse), counted with ``saved_tensors_hooks``.
* ``train_loss`` never calls the SSD scan kernel's entry point
  (``kernels.ssd_scan.ops.ssd_scan``, which has no backward): its mamba
  layers scan with ``mamba2.ssd_chunked``, as the reference trains;
  serving still reaches the entry point.  ``cfg.remat`` (per-layer
  recomputation in the backward) gives bitwise the same loss and
  gradients.  ``cross_entropy`` against the reference's, z-loss included;
  meshes refused."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch import configs as C
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import losses
from repro_torch.models import transformer as T
from repro_torch.pytree import tree_leaves
from trainharness import F32, port_value_and_grad, smoke_batch

FLASH_ATOL = 1e-5

# (causal, window, Sq, Sk): none of them multiples of the chunks (8, 16)
FLASH_CASES = {"causal": (True, None, 37, 37),
               "windowed": (True, 7, 37, 37),
               "bidirectional": (False, None, 37, 45)}


def flash_inputs(seed, sq, sk, dtype=np.float32, b=2, h=3, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(dtype)
    k = rng.standard_normal((b, sk, h, hd)).astype(dtype)
    v = rng.standard_normal((b, sk, h, hd)).astype(dtype)
    do = rng.standard_normal((b, sq, h, hd)).astype(dtype)
    return q, k, v, do


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_reference_custom_vjp(case):
    causal, window, sq, sk = FLASH_CASES[case]
    q, k, v, do = flash_inputs(0, sq, sk)
    jg = jax.grad(lambda q, k, v: jnp.sum(JA.chunked_attention(
        q, k, v, causal, window, 8, 16) * do), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = A.chunked_attention(tq, tk, tv, causal, window, 8, 16)
    (out * torch.from_numpy(do)).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FLASH_ATOL, err_msg=f"d{name}")


def forward_before(q, k, v, causal=True, window=None, q_chunk=512,
                   k_chunk=1024):
    """``chunked_attention`` as it was before it had a backward, verbatim:
    the serving path's forward, which the new one must keep bit for bit."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qc, kc = min(q_chunk, sq), min(k_chunk, sk)
    qpad, kpad = (-sq) % qc, (-sk) % kc
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, qpad))
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))
    nq, nk = (sq + qpad) // qc, (sk + kpad) // kc
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for qi in range(nq):
        qx = q[:, qi * qc:(qi + 1) * qc]
        m = torch.full((b, h, qc), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32, device=dev)
        qpos = qi * qc + torch.arange(qc, device=dev)[:, None]
        for kj in range(nk):
            kx = k[:, kj * kc:(kj + 1) * kc]
            vx = v[:, kj * kc:(kj + 1) * kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qx.float(),
                             kx.float()) * scale
            kpos = kj * kc + torch.arange(kc, device=dev)[None, :]
            msk = kpos < sk
            if causal:
                msk = msk & (kpos <= qpos)
            if window is not None:
                msk = msk & (kpos > qpos - window)
            s = s + torch.where(msk, 0.0, A.NEG)[None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vx.dtype), vx).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.movedim(1, 2))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_forward_without_grad_is_bitwise_the_serving_forward(case,
                                                                  dtype):
    causal, window, sq, sk = FLASH_CASES[case]
    q, k, v, _ = (torch.from_numpy(a).to(dtype)
                  for a in flash_inputs(1, sq, sk))
    with torch.no_grad():
        got = A.chunked_attention(q, k, v, causal, window, 8, 16)
    want = forward_before(q, k, v, causal, window, 8, 16)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(A.chunked_attention(q, k, v, causal, window),
                       forward_before(q, k, v, causal, window))


def test_flash_saves_only_q_k_v_out_and_lse():
    q, k, v, do = flash_inputs(2, 37, 45)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = A.chunked_attention(tq, tk, tv, False, None, 8, 16)
    assert len(saved) == 5
    assert [tuple(t.shape) for t in saved] == [
        (2, 37, 3, 8), (2, 45, 3, 8), (2, 45, 3, 8), (2, 37, 3, 8),
        (2, 3, 37)]
    assert saved[0] is tq and saved[1] is tk and saved[2] is tv
    assert torch.equal(saved[3], out.detach())
    lse = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", tq, tk).detach()
                          * 8 ** -0.5, dim=-1)
    np.testing.assert_allclose(saved[4].numpy(), lse.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_train_loss_never_calls_the_scan_kernel(arch, monkeypatch):
    cfg = C.reduced(C.get(arch), **F32)
    p = T.init(cfg, torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg, S=40).items()}
    calls = []
    entry = ssd_ops.ssd_scan

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return entry(*a, **kw)
    monkeypatch.setattr(ssd_ops, "ssd_scan", counted)
    loss, _, g = port_value_and_grad(cfg, p, b)
    assert calls == [] and np.isfinite(float(loss))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(g))
    with torch.no_grad():
        T.forward(cfg, p, b)
    assert len(calls) == cfg.num_layers


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-1.2b",
                                  "olmoe-1b-7b"])
def test_remat_gives_bitwise_the_same_gradients(arch):
    cfg = C.reduced(C.get(arch), **F32)
    cfg_r = dataclasses.replace(cfg, remat=True)
    p = T.init(cfg, torch.Generator().manual_seed(3))
    b = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg).items()}
    loss, _, g = port_value_and_grad(cfg, p, b)
    loss_r, _, g_r = port_value_and_grad(cfg_r, p, b)
    assert torch.equal(loss, loss_r)
    for a, c in zip(tree_leaves(g), tree_leaves(g_r)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  z_loss))
    got = float(L.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), z_loss))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_meshes_are_refused(tmp_path):
    """Over a 1 x 1 mesh (a one-rank ``gloo`` group) ``train_loss`` and
    ``vocab_parallel_ce`` give the plain path's loss and gradient bit for
    bit (each merge over one rank is the identity), and sequence
    parallelism gives the loss within 1e-5 (the flash path's rounding)."""
    import distharness
    cfg = C.reduced(C.get("qwen2-1.5b"), **F32)
    p = T.init(cfg, torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg).items()}
    want = T.train_loss(cfg, p, b)[0]
    x = torch.randn(1, 2, 64, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([[3, 60]], dtype=torch.int32)
    table = p["embed"]["table"]
    with distharness.one_rank_mesh(tmp_path) as mesh:
        assert torch.equal(T.train_loss(cfg, p, b, mesh=mesh)[0], want)
        sp = T.train_loss(cfg, p, b, mesh=mesh, seq_parallel=True)[0]
        assert abs(float(sp) - float(want)) < 1e-5
        w = table.clone().requires_grad_()
        got = losses.vocab_parallel_ce(x, w, y, mesh=mesh, tied=True)
        gw, = torch.autograd.grad(got, [w])
    w = table.clone().requires_grad_()
    plain = losses.vocab_parallel_ce(x, w, y, tied=True)
    gp, = torch.autograd.grad(plain, [w])
    assert torch.equal(got, plain) and torch.equal(gw, gp)
