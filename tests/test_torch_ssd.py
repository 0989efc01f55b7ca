"""The port's SSD (Mamba-2 state-space duality) against the JAX package:
the SSD kernel's plain twin against the reference's Pallas kernel (run in
interpret mode, as tests/test_kernels.py runs it) and, with a carried
state, against ``ssd_chunked_ref(init_state=...)``; the port's own
``ssd_chunked_ref`` and ``ssd_decode_step`` against the reference's; the
kernel's inputs at the chunk step's live length; the tensor-core body's
product arithmetic (``_ssd_split_torch``) against the plain version; the
CUDA wrapper's input checks and its launch plan (body, P slices, CUDA
kernels a call). Inputs are numpy-seeded, f32, at the reference kernel
test's scales.

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
# the card's kernel against its plain version (tests/test_torch_gpu.py,
# chip_smoke.py): the reference's SSD kernel test's limit
SSD_TOL = dict(rtol=2e-3, atol=2e-4)
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
    (dict(body="wgmma"), "body"),
    (dict(body="mma"), "multiples of 16"),
    (dict(xdt=torch.zeros(2 * 64 * 16 + 1)[1:].view(1, 2, 64, 16)),
     "16-byte aligned"),
], ids=["cpu", "a_shape", "c_shape", "groups", "head_dim", "state_dim",
        "chunk", "init_layout", "body", "mma_shape", "misaligned"])
def test_cuda_wrapper_refuses_bad_inputs(bad, match):
    """The CUDA wrapper checks device, type and shapes before it loads
    anything (so these run without a card)."""
    kw = dict(_kernel_args(), chunk=32)
    kw.update(bad)
    args = [kw.pop(k) for k in ("xdt", "b", "c", "a")]
    with pytest.raises(ValueError, match=match):
        tssdk._ssd_cuda(*args, **kw)


@pytest.mark.parametrize("t,chunk,want", [(64, 256, 64), (40, 256, 40),
                                          (256, 256, 256), (300, 256, 512),
                                          (70, 32, 96)])
def test_ssd_inputs_pad_to_the_chunk_the_kernel_takes(t, chunk, want):
    """T is padded to a multiple of q = min(chunk, T), as the reference
    model pads: not at all below one chunk (the engine's chunk step goes
    in at its live length), to whole chunks above. Padded positions are
    zero and the live ones are those of the unpadded inputs."""
    x, B, C, dt, A, _, s0 = _torch(*_inputs(2, t, 4, 16, 2, 8, seed=9,
                                           init=True))
    xk, bk, ck, a, init = tops.ssd_inputs(x, B, C, dt, A, chunk, s0)
    assert xk.shape == (2, 4, want, 16) and a.shape == (2, 4, want)
    assert bk.shape == ck.shape == (2, 2, want, 8)
    assert init.shape == (2, 4, 8, 16)
    for full in (xk, bk, ck):
        assert not full[:, :, t:].any()
    assert not a[:, :, t:].any()
    live = tops.ssd_inputs(x, B, C, dt, A, t, s0)
    for got, ref in zip((xk, bk, ck), live[:3]):
        assert torch.equal(got[:, :, :t], ref)
    assert torch.equal(a[:, :, :t], live[3])


@pytest.mark.parametrize("t", [64, 40])
def test_chunk_step_at_its_live_length_matches_reference(t):
    """``kernels.ops.ssd`` on a chunk step shorter than the chunk (T=64
    and a ragged 40, chunk 256, a carried state), which the kernel now
    takes unpadded, against the reference's ``ssd_chunked_ref``."""
    x, B, C, dt, A, D, s0 = _inputs(1, t, 4, 16, 1, 32, seed=10, init=True)
    yr, sr = rssd.ssd_chunked_ref(*_jax(x, B, C, dt, A, D), chunk=256,
                                  init_state=jnp.asarray(s0))
    yt, st = tops.ssd(*_torch(x, B, C, dt, A, D), chunk=256,
                      init_state=torch.from_numpy(s0))
    _close(yt, yr)
    _close(st, sr)


def _split_errs(shape, init, parts):
    b, t, h, p, g, n, chunk = shape
    x, B, C, dt, A, _, s0 = _torch(*_inputs(b, t, h, p, g, n, seed=11,
                                            init=init))
    args = tops.ssd_inputs(x, B, C, dt, A, chunk, s0)
    want = tssdk.ssd_chunked_plain(*args[:4], chunk=chunk,
                                   init_state=args[4])
    got = tssdk._ssd_split_torch(*args[:4], chunk=chunk, init_state=args[4],
                                 parts=parts)
    return got, want


# mamba2-130m's chunk step at 4 heads (T=64 against a 256 chunk, N=128,
# P=64, a carried state), two chunks of 32 with G=2, and three chunks of 64
# at mamba2's widths with a carried state
SPLIT_SHAPES = [((1, 64, 4, 64, 1, 128, 256), True),
                ((2, 64, 4, 32, 2, 48, 32), False),
                ((1, 192, 2, 64, 1, 128, 64), True)]


@pytest.mark.parametrize("shape,init", SPLIT_SHAPES, ids=str)
def test_split_products_match_plain(shape, init):
    """The tensor-core body's arithmetic (every product as six bf16 part
    products of exact three-part splits, f32 sums) within ``SSD_TOL`` of
    the plain version, and within the repo's f32 limit: each term is the
    f32 product to within about 2^-24 (measured: y within 6.7e-6, the
    state within 4.8e-7)."""
    got, want = _split_errs(shape, init, 3)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **SSD_TOL)
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.parametrize("shape,init", SPLIT_SHAPES, ids=str)
def test_fewer_parts_lie_further_off(shape, init):
    """Two parts (hi·hi + hi·lo + lo·hi: 2^-16 a term) lie at least 8x
    further from the plain version than three, and hi alone (the planted
    ``SSD_PLANT_HI_ONLY`` build's arithmetic) at least 8x further again
    and past ``SSD_TOL``: the split's error shows on the CPU. Measured at
    the chunk step's shape (max |err| of y, state): three parts 4.3e-6,
    4.8e-7; two 1.9e-4, 2.7e-5; hi alone 5.6e-2, 1.1e-2. The card's FMA
    body lies 7.4e-5, 9.1e-6 from the plain version at its chunk step
    (chip_smoke.py phase 9): two parts would more than double that."""
    errs = []
    for parts in (3, 2, 1):
        got, want = _split_errs(shape, init, parts)
        errs.append(max((a - w).abs().max().item()
                        for a, w in zip(got, want)))
    assert errs[1] >= 8 * errs[0] and errs[2] >= 8 * errs[1], errs
    with pytest.raises(AssertionError):
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **SSD_TOL)


@pytest.mark.parametrize("n,p,body", [(128, 64, "mma"), (48, 32, "mma"),
                                      (16, 16, "mma"), (4, 8, "fma"),
                                      (16, 8, "fma"), (12, 16, "fma")])
def test_body_by_shape(n, p, body):
    assert tssdk.ssd_body(n, p) == body


@pytest.mark.parametrize("t,q,n,p,want", [(1024, 256, 128, 64, 3),
                                          (64, 64, 128, 64, 1),
                                          (256, 256, 128, 64, 1),
                                          (128, 32, 48, 32, 3),
                                          (96, 32, 4, 8, 1)])
def test_kernels_per_call(t, q, n, p, want):
    """The tensor-core body launches its state, pass and output kernels,
    or one fused kernel when T is one chunk; the FMA body one kernel."""
    assert tssdk.kernels_per_call(t, q, n, p) == want


@pytest.mark.parametrize("blocks,p,want", [(24, 64, 4), (96, 64, 2),
                                           (1536, 64, 1), (12, 32, 2),
                                           (6, 48, 1), (1, 128, 8)])
def test_p_split_fills_the_card(blocks, p, want):
    """P slices double while the output blocks number fewer than the 132
    SMs and the slice stays a multiple of 16 (the engine's chunk step: 24
    blocks, four slices of 16)."""
    assert tssdk.p_split(blocks, p, 132) == want
