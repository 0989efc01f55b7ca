"""The port's layer primitives against ``repro.models.layers`` on the same
numpy-seeded inputs. f32 results at the repo's f32 kernel tolerance
(2e-5), bf16 results at its bf16 tolerance (3e-2, tests/test_kernels.py):
the two frameworks sum products in different orders, so bf16 roundings
may land one ulp apart."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models.lm import LM
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as PortLM

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


def _pair(rng, shape, dt, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DT[dt]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j).astype(np.float32), **tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("out", ["default", "f32"])
@pytest.mark.parametrize("n_in", [1, 2])
def test_dense(dt, out, n_in):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 4, 8) if n_in == 2 else (2, 5, 32), dt)
    wj, wt = _pair(rng, (4, 8, 24) if n_in == 2 else (32, 24), dt, 0.2)
    bj, bt = _pair(rng, (24,), dt)
    kw_j = {"out_dtype": jnp.float32} if out == "f32" else {}
    kw_t = {"out_dtype": torch.float32} if out == "f32" else {}
    yj = JL.dense(xj, wj, n_in=n_in, bias=bj, **kw_j)
    yt = TL.dense(xt, wt, n_in=n_in, bias=bt, **kw_t)
    assert yt.dtype == (torch.float32 if out == "f32" else DT[dt][1])
    _close(yj, yt, F32 if (dt == "f32" or out == "f32") else BF16)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm(dt):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (3, 7, 64), dt)
    wj, wt = _pair(rng, (64,), dt)
    _close(JL.rmsnorm(xj, wj, 1e-5), TL.rmsnorm(xt, wt, 1e-5),
           F32 if dt == "f32" else BF16)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_rope(fraction, dt):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (2, 9, 4, 16), dt)
    pos = rng.integers(0, 1000, (2, 9))
    yj = JL.apply_rope(xj, jnp.asarray(pos), fraction, 10000.0)
    yt = TL.apply_rope(xt, torch.tensor(pos), fraction, 10000.0)
    _close(yj, yt, F32 if dt == "f32" else BF16)
    inv_j, rot_j = JL.rope_frequencies(16, fraction, 10000.0)
    inv_t, rot_t = TL.rope_frequencies(16, fraction, 10000.0)
    assert rot_j == rot_t
    np.testing.assert_array_equal(np.asarray(inv_j), inv_t)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_swiglu(dt):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (2, 6, 32), dt)
    gj, gt = _pair(rng, (32, 48), dt, 0.2)
    uj, ut = _pair(rng, (32, 48), dt, 0.2)
    dj, dtt = _pair(rng, (48, 32), dt, 0.2)
    _close(JL.swiglu(xj, gj, uj, dj), TL.swiglu(xt, gt, ut, dtt),
           F32 if dt == "f32" else BF16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_naive_attention(causal, h, kv, dt):
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (2, 7, h, 16), dt)
    kj, kt = _pair(rng, (2, 7, kv, 16), dt)
    vj, vt = _pair(rng, (2, 7, kv, 16), dt)
    _close(JL.naive_attention(qj, kj, vj, causal=causal),
           TL.naive_attention(qt, kt, vt, causal=causal),
           F32 if dt == "f32" else BF16)


def test_qkv_and_blocks_match_reference():
    """The dense blocks (QKV bias, f32 chain, one rounding; prefill
    attention; SwiGLU FFN) on bridged smoke weights."""
    import jax
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    tcfg = port_config("qwen1.5-0.5b", reduced=True)
    params = jax.device_get(LM(cfg).init(jax.random.PRNGKey(0)))
    # non-zero biases so the bias path is exercised
    rng = np.random.default_rng(6)
    for b in ("bq", "bk", "bv"):
        leaf = params["blocks"]["pos0"]["mix"][b]
        params["blocks"]["pos0"]["mix"][b] = np.asarray(
            rng.standard_normal(leaf.shape) * 0.1, leaf.dtype)
    tparams = from_jax_numpy(params)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["pos0"])
    tlp = PortLM(tcfg, device="cpu").layer_params(tparams, 0)
    xj, xt = _pair(rng, (2, 11, 64), "bf16")
    pos = np.arange(11)[None]
    qj = JB._qkv(xj, lp["mix"], cfg, None, positions=jnp.asarray(pos))
    qt = TB._qkv(xt, tlp["mix"], tcfg, torch.tensor(pos))
    for a, b in zip(qj, qt):
        assert b.dtype == torch.bfloat16
        _close(a, b, BF16)
    yj, kvj = JB.attn_apply(xj, lp["mix"], cfg, None, attn_impl="naive",
                            positions=jnp.asarray(pos), return_kv=True)
    yt, kvt = TB.attn_apply(xt, tlp["mix"], tcfg,
                            positions=torch.tensor(pos), return_kv=True)
    _close(yj, yt, BF16)
    _close(kvj["k"], kvt["k"], BF16)
    _close(JB.ffn_apply(xj, lp["ffn"], cfg, None),
           TB.ffn_apply(xt, tlp["ffn"], tcfg), BF16)
