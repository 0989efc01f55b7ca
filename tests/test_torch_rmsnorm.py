"""RMSNorm: the port's plain version against the JAX package's Pallas
kernel (interpret mode) at the reference kernel test's shapes, the
analytic backward of the autograd wrapper against autograd through the
plain version, and the models' ``layers.rmsnorm`` routing. The CUDA
kernel's own tests, which need a card and no JAX, are in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.models import layers as L

# tests/test_kernels.py:22-23, the reference kernel test's tolerances
TOL = {"bf16": dict(atol=3e-2, rtol=3e-2), "f32": dict(atol=2e-5, rtol=2e-5)}
JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU ops on the calling thread: in some processes one
    worker of torch's thread pool evaluates f32 exp at ~1.5e-4 relative
    error (see tests/test_torch_ssd.py), above these tests' limits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    # rows at magnitudes 1e-3..10, so eps matters in some of them
    scale = 10.0 ** rng.uniform(-3, 1, (rows, 1))
    x = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    w = (rng.standard_normal(d) + 1.0).astype(np.float32)
    return x, w


def _cast(a, dt):
    """numpy f32 -> the same values as a torch tensor of ``dt`` (bf16
    rounds like JAX's astype: to nearest even)."""
    return torch.from_numpy(a).to(TDT[dt])


# tests/test_kernels.py:353-355
@pytest.mark.parametrize("rows,d", [(64, 128), (1024, 512), (333, 256)])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_plain_matches_pallas_kernel(rows, d, dt):
    x, w = _inputs(rows, d)
    want = rops.rmsnorm(jnp.asarray(x).astype(JDT[dt]),
                        jnp.asarray(w).astype(JDT[dt]))
    before = trn.LAUNCHES["rmsnorm"]
    got = trn.rmsnorm(_cast(x, dt), _cast(w, dt))
    assert got.dtype == TDT[dt]
    assert trn.LAUNCHES["rmsnorm"] == before       # CPU: the plain version
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dt])


def test_plain_is_the_models_former_body_bitwise():
    """``layers.rmsnorm`` on the CPU is the plain version, whose bf16/f32
    arithmetic is the models' former body op for op."""
    x, w = _inputs(37, 96, seed=3)
    for xd, wd in (("bf16", "bf16"), ("f32", "bf16"), ("f32", "f32")):
        xt, wt = _cast(x, xd), _cast(w, wd)
        xf = xt.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        want = (xf * torch.rsqrt(var + 1e-5) * wt.float()).to(xt.dtype)
        assert torch.equal(L.rmsnorm(xt, wt, 1e-5), want)
        assert torch.equal(tops.rmsnorm(xt, wt, 1e-5), want)


def test_autograd_function_gradcheck_f64():
    """The analytic backward of ``_RMSNorm`` against finite differences
    of its forward (the plain version on the CPU), in f64."""
    x, w = _inputs(6, 24, seed=1)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    wt = torch.from_numpy(w).double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: tops._RMSNorm.apply(a, b, 1e-5), (xt, wt),
        eps=1e-6, atol=1e-8, rtol=1e-6)


@pytest.mark.parametrize("xd,wd", [("f32", "f32"), ("bf16", "bf16"),
                                   ("f32", "bf16")])
def test_analytic_backward_matches_autograd_through_plain(xd, wd):
    """dx and dw of the wrapper's backward against autograd through the
    plain forward: f32 within 2e-5 (f32 summation order), bf16 within one
    bf16 ulp (both round one f32 value once)."""
    x, w = _inputs(33, 64, seed=2)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    grads = []
    for fwd in (lambda a, b: tops._RMSNorm.apply(a, b, 1e-5),
                lambda a, b: trn.rmsnorm_plain(a, b, 1e-5)):
        xt = _cast(x, xd).requires_grad_(True)
        wt = _cast(w, wd).requires_grad_(True)
        out = fwd(xt, wt)
        grads.append(torch.autograd.grad(
            out, (xt, wt), _cast(dy, xd)))
    for got, want, dt in zip(grads[0], grads[1], (xd, wd)):
        assert got.dtype == want.dtype == TDT[dt]
        g, r = got.float(), want.float()
        if dt == "f32":
            torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5)
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                r.abs().clamp_min(1e-30))) - 7)
            assert bool(((g - r).abs() <= ulp + 1e-6).all())


def test_cpu_route_is_autograd_through_plain():
    """On CPU tensors ``ops.rmsnorm`` is the plain version with autograd
    through its ops, so CPU training keeps its numbers exactly."""
    x, w = _inputs(9, 32, seed=5)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).bfloat16().requires_grad_(True)
    out = tops.rmsnorm(xt, wt)
    assert out.grad_fn is not None
    assert "RMSNorm" not in type(out.grad_fn).__name__


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("w_shape", "w must be"),
    ("dtype", "f32 or bf16"), ("too_wide", "must be in")])
def test_cuda_wrapper_refuses_bad_inputs(case, match):
    x = torch.zeros((4, 64))
    w = torch.zeros(64)
    if case == "w_shape":
        w = torch.zeros(32)
    elif case == "dtype":
        x = x.half()
    elif case == "too_wide":
        x, w = torch.zeros((2, trn.MAX_D + 1)), torch.zeros(trn.MAX_D + 1)
    before = trn.LAUNCHES["rmsnorm"]
    with pytest.raises(ValueError, match=match):
        trn._rmsnorm_cuda(x, w)
    assert trn.LAUNCHES["rmsnorm"] == before
