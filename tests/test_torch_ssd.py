"""The port's SSD (Mamba-2 state-space duality) against the JAX package:
the SSD kernel's plain twin against the reference's Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it) and, with a carried
state, against ``ssd_chunked_ref(init_state=...)``; the port's own
``ssd_chunked_ref`` and ``ssd_decode_step`` against the reference's; the
CUDA wrapper's input checks. Inputs are numpy-seeded, f32, at the
reference kernel test's scales.

Tolerance: rtol = atol = 2e-5 in f32 (the repo's f32 kernel tolerance).
Measured against the reference (|err| / (atol + rtol |want|), worst
element): up to 0.86 at (2, 256, 4, 64, 2, 64, 128) with a carried
state and 0.73 without, where XLA's and torch's cumulative sums of the
decay round differently; at most 0.35 at the other shapes.

Every test runs torch's CPU ops on the calling thread (``one_thread``).
With torch's default thread pool, in about one process in five (torch
2.13 with MKL on an 8-core x86 CPU, with or without JAX imported) one
OpenMP worker evaluates f32 ``torch.exp`` over its 2,048-element chunk
with a relative error near 1.5e-4 instead of 6e-8; the twin's decay
matrix is large enough to be split over the pool, which moved the first
shape's worst ratio from 0.35 to 5.8-8.1 (4 of 25 fresh processes
failed). On the calling thread the same exp is accurate in every
process measured (0 of 25 failed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ssd as rssdk
from repro.models import ssd as rssd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd as tssdk
from repro_torch.models import ssd as tssd

TOL = dict(rtol=2e-5, atol=2e-5)
# tests/test_kernels.py:316-320, plus G=2 with T not a multiple of chunk
SHAPES = [(1, 128, 2, 64, 1, 128, 64), (2, 256, 4, 64, 2, 64, 128),
          (1, 96, 2, 64, 1, 16, 32), (2, 70, 4, 16, 2, 16, 32)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, h, p, g, n, seed=0, init=False):
    rng = np.random.default_rng(seed)

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, B, C = rn(b, t, h, p) * 0.5, rn(b, t, g, n) * 0.5, rn(b, t, g, n) * 0.5
    dt = np.asarray(jax.nn.softplus(rn(b, t, h)))
    A = (-np.exp(rn(h) * 0.3)).astype(np.float32)
    D = rn(h)
    state = rn(b, h, p, n) * 0.5 if init else None
    return x, B, C, dt, A, D, state


def _jax(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(a.copy()) for a in arrs]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_twin_matches_pallas_kernel(shape):
    """``kernels.ops.ssd`` (the plain twin on the CPU) against the
    reference's ``kernels.ops.ssd`` through the Pallas kernel."""
    *dims, chunk = shape
    x, B, C, dt, A, D, _ = _inputs(*dims)
    yr, sr = rops.ssd(*_jax(x, B, C, dt, A, D), chunk=chunk)
    yt, st = tops.ssd(*_torch(x, B, C, dt, A, D), chunk=chunk)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == yr.shape
    assert tuple(st.shape) == sr.shape
    _close(yt, yr)
    _close(st, sr)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_twin_in_kernel_layout_matches_pallas(shape):
    """The kernel-layout entry point itself: xdt (B,H,T,P), b/c
    (B,G,T,N), a (B,H,T) -> y (B,H,T,P), state (B,H,N,P)."""
    b, t, h, p, g, n, chunk = shape
    rng = np.random.default_rng(1)
    xdt = rng.standard_normal((b, h, t, p)).astype(np.float32) * 0.3
    bm = rng.standard_normal((b, g, t, n)).astype(np.float32) * 0.5
    cm = rng.standard_normal((b, g, t, n)).astype(np.float32) * 0.5
    a = -rng.uniform(0.0, 1.0, (b, h, t)).astype(np.float32)
    yr, sr = rssdk.ssd_chunked_kernel(*_jax(xdt, bm, cm, a), chunk=chunk,
                                      interpret=True)
    before = tssdk.LAUNCHES["ssd"]
    yt, st = tssdk.ssd_chunked_kernel(*_torch(xdt, bm, cm, a), chunk=chunk)
    assert tssdk.LAUNCHES["ssd"] == before       # CPU: the plain version
    _close(yt, yr)
    _close(st, sr)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_twin_with_init_state_matches_reference_ref(shape):
    *dims, chunk = shape
    x, B, C, dt, A, D, s0 = _inputs(*dims, seed=2, init=True)
    yr, sr = rssd.ssd_chunked_ref(*_jax(x, B, C, dt, A, D), chunk=chunk,
                                  init_state=jnp.asarray(s0))
    yt, st = tops.ssd(*_torch(x, B, C, dt, A, D), chunk=chunk,
                      init_state=torch.from_numpy(s0))
    _close(yt, yr)
    _close(st, sr)


@pytest.mark.parametrize("split", [64, 40], ids=["chunk-aligned", "ragged"])
def test_two_calls_carrying_the_state_equal_one(split):
    """Chunked prefill's contract: the final state of a call seeds the
    next, and the two calls together equal one call over the whole
    sequence (bit for bit when the split is on a chunk boundary)."""
    x, B, C, dt, A, D, _ = _torch(*_inputs(2, 128, 4, 32, 2, 16, seed=3))
    y, s = tops.ssd(x, B, C, dt, A, D, chunk=32)
    y1, s1 = tops.ssd(x[:, :split], B[:, :split], C[:, :split],
                      dt[:, :split], A, D, chunk=32)
    y2, s2 = tops.ssd(x[:, split:], B[:, split:], C[:, split:],
                      dt[:, split:], A, D, chunk=32, init_state=s1)
    got = torch.cat([y1, y2], dim=1)
    if split % 32 == 0:
        assert torch.equal(got, y) and torch.equal(s2, s)
    else:
        torch.testing.assert_close(got, y, **TOL)
        torch.testing.assert_close(s2, s, **TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", SHAPES[2:], ids=str)
def test_port_chunked_ref_matches_reference(shape, init):
    *dims, chunk = shape
    x, B, C, dt, A, D, s0 = _inputs(*dims, seed=4, init=init)
    yr, sr = rssd.ssd_chunked_ref(*_jax(x, B, C, dt, A, D), chunk=chunk,
                                  init_state=None if s0 is None
                                  else jnp.asarray(s0))
    yt, st = tssd.ssd_chunked_ref(*_torch(x, B, C, dt, A, D), chunk=chunk,
                                  init_state=None if s0 is None
                                  else torch.from_numpy(s0))
    _close(yt, yr)
    _close(st, sr)


def test_port_decode_step_matches_reference():
    x, B, C, dt, A, D, s0 = _inputs(3, 1, 4, 16, 2, 16, seed=5, init=True)
    yr, sr = rssd.ssd_decode_step(*_jax(x[:, 0], B[:, 0], C[:, 0], dt[:, 0],
                                        A, D, s0))
    yt, st = tssd.ssd_decode_step(*_torch(x[:, 0], B[:, 0], C[:, 0],
                                          dt[:, 0], A, D, s0))
    _close(yt, yr)
    _close(st, sr)


def test_decode_steps_equal_the_chunked_scan():
    """T single-token recurrences from a carried state agree with one
    chunked pass (the two forms of the same function)."""
    x, B, C, dt, A, D, s0 = _torch(*_inputs(1, 40, 4, 16, 1, 16, seed=6,
                                            init=True))
    y, s = tops.ssd(x, B, C, dt, A, D, chunk=16, init_state=s0)
    st, ys = s0, []
    for i in range(40):
        yi, st = tssd.ssd_decode_step(x[:, i], B[:, i], C[:, i], dt[:, i],
                                      A, D, st)
        ys.append(yi)
    torch.testing.assert_close(torch.stack(ys, dim=1), y, **TOL)
    torch.testing.assert_close(st, s, **TOL)


def test_router():
    """``ssd_chunked(impl="kernel")`` is ``kernels.ops.ssd`` with or
    without a carried state; ``"ref"`` is the chunked reference."""
    x, B, C, dt, A, D, s0 = _torch(*_inputs(1, 50, 2, 16, 1, 16, seed=7,
                                            init=True))
    for init in (None, s0):
        got = tssd.ssd_chunked(x, B, C, dt, A, D, chunk=32, impl="kernel",
                               init_state=init)
        want = tops.ssd(x, B, C, dt, A, D, chunk=32, init_state=init)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        ref = tssd.ssd_chunked(x, B, C, dt, A, D, chunk=32, impl="ref",
                               init_state=init)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, **TOL)
    with pytest.raises(ValueError, match="ssd impl"):
        tssd.ssd_chunked(x, B, C, dt, A, D, impl="pallas")


def test_no_overflow_above_the_diagonal():
    """A strong decay (a = -100 a step) makes cums_i - cums_j large and
    positive above the diagonal, where exp overflows; it is taken only
    where i >= j, so no inf * 0 turns into NaN."""
    b, h, t, p, g, n = 1, 2, 64, 8, 1, 8
    rng = np.random.default_rng(8)
    xdt = torch.from_numpy(rng.standard_normal((b, h, t, p)).astype(
        np.float32))
    bm = torch.from_numpy(rng.standard_normal((b, g, t, n)).astype(
        np.float32))
    a = torch.full((b, h, t), -100.0)
    y, s = tssdk.ssd_chunked_plain(xdt, bm, bm.clone(), a, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def _kernel_args():
    g = torch.Generator().manual_seed(0)
    return dict(xdt=torch.randn((1, 2, 64, 16), generator=g),
                b=torch.randn((1, 1, 64, 8), generator=g),
                c=torch.randn((1, 1, 64, 8), generator=g),
                a=-torch.rand((1, 2, 64), generator=g))


@pytest.mark.parametrize("bad,match", [
    (dict(), "CUDA tensors"),
    (dict(a=torch.zeros((1, 2, 63))), "does not fit"),
    (dict(b=torch.zeros((1, 1, 64, 9))), "do not fit"),
    (dict(b=torch.zeros((1, 3, 64, 8)), c=torch.zeros((1, 3, 64, 8))),
     "heads over"),
    (dict(xdt=torch.zeros((1, 2, 64, 129)), a=torch.zeros((1, 2, 64))),
     "must be in"),
    (dict(b=torch.zeros((1, 1, 64, 6)), c=torch.zeros((1, 1, 64, 6))),
     "multiple of 4"),
    (dict(chunk=48), "multiple of the chunk"),
    (dict(init_state=torch.zeros((1, 2, 16, 8))), "init_state"),
], ids=["cpu", "a_shape", "c_shape", "groups", "head_dim", "state_dim",
        "chunk", "init_layout"])
def test_cuda_wrapper_refuses_bad_inputs(bad, match):
    """The CUDA wrapper checks device, type and shapes before it loads
    anything (so these run without a card)."""
    kw = dict(_kernel_args(), chunk=32)
    kw.update(bad)
    args = [kw.pop(k) for k in ("xdt", "b", "c", "a")]
    with pytest.raises(ValueError, match=match):
        tssdk._ssd_cuda(*args, **kw)
