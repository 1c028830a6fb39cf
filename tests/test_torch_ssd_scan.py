"""Port parity, the SSD scan (K6): the port's ``ssd_scan`` (its plain
version on the CPU) against the reference's Pallas ``ssd_scan`` in
interpret mode (as ``tests/test_kernels.py`` runs it) and against the
oracle ``ssd_chunked`` of both packages, on the same numpy inputs; the
ragged last chunk masked against zero-padded; the wrapper's checks."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_heads as j_ssd_scan_heads
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.kernel import SSDScan, plain
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

TOL = 1e-4          # the reference's kernel-vs-oracle bound (rtol = atol)
ORACLE_TOL = 1e-5   # the two packages' ssd_chunked, float32, same algorithm
REF_BF16_TOL = 0.1  # the reference's bfloat16 bound (test_ssd_scan_bf16_inputs)
BF16_REL = 1e-5     # bfloat16 y: 1e-5 x max|y| plus one bfloat16 ulp

# (b, S, H, P, G, N, chunk): the reference test's three shapes, and heads
# at full width (mamba2-780m's P = 64, N = 128, chunk 256) over two chunks,
# the second ragged
SHAPES = [(1, 32, 2, 8, 1, 8, 8), (2, 80, 4, 8, 2, 16, 16),
          (2, 100, 4, 16, 4, 8, 32)]
FULL = (1, 300, 4, 64, 1, 128, 256)


def inputs(seed, b, s, h, p, g, n):
    """Drawn as the reference test draws them (softplus dt, negative A),
    with numpy."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(r.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(r.standard_normal(h)).astype(np.float32)
    B = r.standard_normal((b, s, g, n)).astype(np.float32)
    C = r.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def tk(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def close(got, want, tol, scale=1.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * scale)


def y_scale(shape, want):
    """The absolute part of y's bound: 1 on the reference's shapes, max|y|
    at full width.  There a chunk's float32 cumsum reaches |cs| ~ 400,
    where one float32 ulp (3e-5) is a relative error of every decay, and
    two float32 scans that add in different orders (the reference's
    ``jnp.cumsum``, the port's left-to-right one) differ by about 1e-3 on
    outputs of a few hundred (ROADMAP C3)."""
    return float(np.abs(np.asarray(want)).max()) if shape == FULL else 1.0


def bf16(a):
    """A bfloat16 numpy array as the same bfloat16 tensor (exact)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def ulp_bf16(v):
    """One bfloat16 ulp at each value's magnitude (8 significand bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


@pytest.mark.parametrize("shape", SHAPES + [FULL])
def test_plain_matches_reference_kernel_float32(shape):
    b, s, h, p, g, n, chunk = shape
    x, dt, A, B, C = inputs(4, b, s, h, p, g, n)
    want_y, want_st = j_ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)),
                                 chunk=chunk)
    y, st = ops.ssd_scan(*tk(x, dt, A, B, C), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, n, p)
    close(y, want_y, TOL, y_scale(shape, want_y))
    close(st, want_st, TOL)
    # and against the oracle, the port's own ssd_chunked
    ry, rst = ssd_scan_ref(*tk(x, dt, A, B, C), chunk=chunk)
    close(y, ry, TOL, y_scale(shape, ry))
    close(st, rst, TOL)


def test_full_width_float32_error_against_float64():
    """At full width both packages' float32 scans are within 1e-5 x max|y|
    of the same function in float64 (the port's ``ssd_chunked``), the
    state within 1e-6 x max|state|: the bound above is the float32 scan's
    own, not a port fault."""
    b, s, h, p, g, n, chunk = FULL
    x, dt, A, B, C = inputs(4, b, s, h, p, g, n)
    ty, ts = ssd_scan_ref(*[torch.from_numpy(a.astype(np.float64))
                            for a in (x, dt, A, B, C)], chunk=chunk)
    ky, ks = j_ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk)
    py, ps = ops.ssd_scan(*tk(x, dt, A, B, C), chunk=chunk)
    ymax, smax = float(ty.abs().max()), float(ts.abs().max())
    for y, st in ((np.asarray(ky), np.asarray(ks)), (py.numpy(), ps.numpy())):
        assert np.abs(y - ty.numpy()).max() <= 1e-5 * ymax
        assert np.abs(st - ts.numpy()).max() <= 1e-6 * smax


@pytest.mark.parametrize("shape", [SHAPES[0], FULL])
def test_plain_matches_reference_kernel_bfloat16(shape):
    """bfloat16 x, B, C: both sum in float32 and round y once, in different
    orders, so y may differ by one bfloat16 ulp beyond the float32 bound
    (1e-5 x max|y| here; the reference holds its kernel to 0.1); the
    float32 state is held at 1e-4."""
    b, s, h, p, g, n, chunk = shape
    x, dt, A, B, C = inputs(5, b, s, h, p, g, n)
    xb, Bb, Cb = (a.astype(ml_dtypes.bfloat16) for a in (x, B, C))
    want_y, want_st = j_ssd_scan(jnp.asarray(xb), jnp.asarray(dt),
                                 jnp.asarray(A), jnp.asarray(Bb),
                                 jnp.asarray(Cb), chunk=chunk)
    y, st = ops.ssd_scan(bf16(xb), torch.from_numpy(dt), torch.from_numpy(A),
                         bf16(Bb), bf16(Cb), chunk=chunk)
    assert y.dtype == torch.bfloat16
    got, want = y.float().numpy(), np.asarray(want_y).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=REF_BF16_TOL,
                               atol=REF_BF16_TOL)
    lim = BF16_REL * np.abs(want).max() + ulp_bf16(want)
    assert (np.abs(got - want) <= lim).all()
    close(st, want_st, TOL)


def test_plain_matches_reference_per_head_layout():
    """The kernel layer itself: ``plain`` against ``ssd_scan_heads`` on the
    per-head layout (S a multiple of the chunk, as the reference needs)."""
    r = np.random.default_rng(6)
    bh, s, p, n, chunk = 3, 96, 16, 8, 32
    x = r.standard_normal((bh, s, p)).astype(np.float32)
    dt = np.logaddexp(r.standard_normal((bh, s, 1)), 0).astype(np.float32)
    A = -np.exp(r.standard_normal((bh, 1))).astype(np.float32)
    B = r.standard_normal((bh, s, n)).astype(np.float32)
    C = r.standard_normal((bh, s, n)).astype(np.float32)
    want_y, want_st = j_ssd_scan_heads(*map(jnp.asarray, (x, dt, A, B, C)),
                                       chunk=chunk)
    y, st = plain(*tk(x, dt, A, B, C), chunk=chunk)
    close(y, want_y, TOL)
    close(st, want_st, TOL)


@pytest.mark.parametrize("shape", SHAPES + [FULL])
def test_ssd_chunked_matches_reference(shape):
    b, s, h, p, g, n, chunk = shape
    x, dt, A, B, C = inputs(7, b, s, h, p, g, n)
    h0 = np.random.default_rng(8).standard_normal((b, h, n, p)).astype(
        np.float32)
    for init in (None, h0):
        want_y, want_st = j_ssd_chunked(
            *map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
            h0=None if init is None else jnp.asarray(init))
        y, st = ssd_scan_ref(*tk(x, dt, A, B, C), chunk=chunk,
                             h0=None if init is None else
                             torch.from_numpy(init))
        close(y, want_y, ORACLE_TOL, y_scale(shape, want_y))
        close(st, want_st, ORACLE_TOL)


def test_ragged_chunk_masked_equals_zero_padded():
    """The kernel's plain version masks the last chunk (it is shorter); the
    reference zero-pads S to a multiple of the chunk.  Padded rows have
    dt = 0, so y and the final state agree (to the float32 sum order)."""
    b, s, h, p, g, n, chunk = FULL
    x, dt, A, B, C = inputs(9, b, s, h, p, g, n)
    pad = (-s) % chunk
    padded = [np.concatenate([a, np.zeros((b, pad) + a.shape[2:], a.dtype)],
                             axis=1) for a in (x, dt, B, C)]
    y, st = ops.ssd_scan(*tk(x, dt, A, B, C), chunk=chunk)
    yp, stp = ops.ssd_scan(*tk(padded[0], padded[1], A, padded[2],
                               padded[3]), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), yp[:, :s].numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), stp.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not yp[:, s:].any()


def test_wrapper_checks_and_counts_no_cpu_launch():
    scan = SSDScan()
    before = SSDScan.launches
    x = torch.zeros(2, 8, 4)
    dt, A = torch.ones(2, 8, 1), -torch.ones(2, 1)
    B = C = torch.zeros(2, 8, 3)
    y, st = scan(x, dt, A, B, C, chunk=4)
    assert y.shape == (2, 8, 4) and st.shape == (2, 3, 4)
    assert SSDScan.launches == before         # the plain path never counts
    bad = [lambda: scan(x.double(), dt, A, B, C, chunk=4),
           lambda: scan(x, dt, A, B.to(torch.bfloat16), C, chunk=4),
           lambda: scan(x, dt[:, :, 0], A, B, C, chunk=4),
           lambda: scan(x, dt, A[:, 0], B, C, chunk=4),
           lambda: scan(x, dt, A, B[:, :7], C, chunk=4),
           lambda: scan(x, dt, A, B, C, chunk=0)]
    for call in bad:
        with pytest.raises((TypeError, ValueError)):
            call()


def test_reference_scans_round_bfloat16_differently():
    """ROADMAP C3 (reference-side): in float32 the reference's Pallas scan
    and its ``ssd_chunked`` agree (the same ``jnp.cumsum``); in bfloat16
    ``ssd_chunked`` rounds M, and ``y_diag`` and ``y_off`` apart, before
    their sum, so it leaves the kernel's function (one float32 sum, one
    rounding), which is the one the port's K6 computes."""
    b, s, h, p, g, n, chunk = FULL
    x, dt, A, B, C = inputs(5, b, s, h, p, g, n)
    diffs, outs = {}, {}
    for name, cast in (("float32", lambda a: a),
                       ("bfloat16", lambda a: a.astype(ml_dtypes.bfloat16))):
        args = [jnp.asarray(cast(x)), jnp.asarray(dt), jnp.asarray(A),
                jnp.asarray(cast(B)), jnp.asarray(cast(C))]
        ky = np.asarray(j_ssd_scan(*args, chunk=chunk)[0], np.float32)
        cy = np.asarray(j_ssd_chunked(*args, chunk=chunk)[0], np.float32)
        d = np.abs(ky - cy)
        diffs[name], outs[name] = d, ky
        print(f"{name}: reference kernel vs ssd_chunked max |y diff| "
              f"{d.max():.4g} on max|y| {np.abs(cy).max():.4g}, "
              f"{(d > 0).mean():.2%} of outputs differ, up to "
              f"{(d / ulp_bf16(np.abs(cy))).max():.4g} bfloat16 ulps of the "
              f"output")
    assert diffs["float32"].max() <= ORACLE_TOL * np.abs(outs["float32"]).max()
    ky = outs["bfloat16"]
    lim = BF16_REL * np.abs(ky).max() + ulp_bf16(ky)
    assert (diffs["bfloat16"] > lim).any()
