"""The port's LoRA fine-tuning against the JAX package on the same numpy
inputs and the same bridged train state, at the reduced qwen1.5-0.5b
size: ``apply_lora``'s wrapping, the trainable/frozen split, ``dense``'s
dispatch on int8, nf4 and LoRA weights, the loss and the adapters'
gradients, whole train steps, and the launcher. ``QL+Q8`` (LoRA on an
int8 base) is the technique whose projections run the int8 kernel; ``L``
(a bf16 base) shares the code.

The adapters' B starts at zero, which makes A's gradient exactly zero:
the comparisons set B to seeded nonzero values first, on both sides."""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import technique_from_label as jtech
from repro.models import layers as JL
from repro.models.lm import LM as JLM
from repro.parallel.sharding import make_shard_ctx
from repro.peft import lora as jlora
from repro.quant import qtensor as jq
from repro.train import optimizer as jopt
from repro.train.step import build_train_step as jbuild
from repro.train.step import init_train_state as jinit
from repro_torch.bridge import from_jax_numpy, to_numpy, train_state_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.core.config import technique_from_label
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.launch import train as train_cli
from repro_torch.launch.build import make_model
from repro_torch.models import layers as L
from repro_torch.models.params import tree_paths
from repro_torch.peft.lora import (DEFAULT_TARGETS, LoRATensor,
                                   merge_trainable, split_trainable)
from repro_torch.quant.qtensor import QTensor, quantize_int8, quantize_nf4
from repro_torch.train import optimizer as topt
from repro_torch.train.step import build_train_step, init_train_state

ARCH = "qwen1.5-0.5b"
B, T, RANK = 2, 64, 4
LABELS = ["QL+Q8", "L"]
# tests/test_torch_train.py's limits: bf16 logits of the two frameworks
# round one ulp apart here and there (f32 sums in other orders)
LOSS_ATOL = 2e-3
GRAD_COS = 0.999
# qmm_impl="kernel" keeps each dequantized weight in f32 where the
# reference rounds it to bf16 first (a relative change of up to 2^-9 per
# weight). Measured at this size on QL+Q8 against the reference: |dloss|
# 5.5e-4 and worst adapter gradient cosine 0.99968 (qmm_impl="ref":
# 8.7e-5 and 0.99990); the limits keep 3.6x and 3x room
KERNEL_LOSS_ATOL = 2e-3
KERNEL_GRAD_COS = 0.999


def _jtech(label):
    return jtech(label, lora_rank=RANK)


def _ptech(label):
    return technique_from_label(label, lora_rank=RANK)


def _set_b(state, seed=0):
    """Seeded nonzero B on every adapter of a numpy reference state."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, jlora.LoRATensor):
            tree.b = (rng.standard_normal(tree.b.shape) * 0.1).astype(
                tree.b.dtype)

    walk(state["params"])
    return state


@pytest.fixture(scope="module")
def batch():
    cfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, (B, T), dtype=np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    lab[0, :5] = -1
    return {"tokens": tok, "labels": lab}


@pytest.fixture(scope="module", params=LABELS)
def ref_state(request):
    """(label, the reference's train state as numpy with nonzero B)."""
    cfg = get_config(ARCH, reduced=True)
    state, _ = jinit(JLM(cfg), _jtech(request.param), jax.random.PRNGKey(0),
                     jopt.AdamWConfig(lr=5e-3, warmup=0))
    return request.param, _set_b(jax.device_get(state))


@pytest.fixture
def keep_sigterm():
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jbatch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _kind(leaf) -> str:
    """A leaf's class name if it is a QTensor or LoRATensor of either
    side, else "array"."""
    name = type(leaf).__name__
    return name if name in ("QTensor", "LoRATensor") else "array"


def _ref_paths(tree):
    """The reference tree's numpy leaves under the port's path names."""
    return dict(tree_paths(to_numpy(from_jax_numpy(tree))))


# --------------------------------------------------------------------------
# the LoRA-fied state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("label", LABELS)
def test_init_wraps_the_same_leaves_as_the_reference(label):
    """The same leaves quantized and wrapped, with the same shapes,
    dtypes, kinds and scaling; A drawn at 1/sqrt(fan_in), B zero; the
    optimizer state covers the adapters only."""
    cfg = get_config(ARCH, reduced=True)
    jstate = jax.device_get(jinit(JLM(cfg), _jtech(label),
                                  jax.random.PRNGKey(0))[0])
    model = make_model(port_config(ARCH, reduced=True), _ptech(label),
                       device="cpu")
    pstate, _ = init_train_state(model, _ptech(label), 0)
    want = _ref_paths(jstate)
    got = dict(tree_paths(to_numpy(pstate)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert got[path].dtype == w.dtype, path

    def nodes(tree, out, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                nodes(v, out, p)
            else:
                out[p] = v
        return out

    jn = nodes(jstate["params"], {})
    pn = nodes(pstate["params"], {})
    assert jn.keys() == pn.keys()
    wrapped = []
    for path, jv in jn.items():
        pv = pn[path]
        assert _kind(pv) == _kind(jv), path
        if isinstance(pv, LoRATensor):
            wrapped.append(path.rsplit("/", 1)[-1])
            assert pv.scaling == jv.scaling == 16.0 / RANK
            assert torch.all(pv.b == 0) and pv.a.requires_grad
            body = pv.a.shape[1:-1]
            fan_in = int(np.prod(body))
            assert abs(float(pv.a.float().std()) * fan_in ** 0.5 - 1) < 0.2
            pv = pv.base
            jv = jv.base
        assert _kind(pv) == _kind(jv), path
        if isinstance(pv, QTensor):
            assert (pv.kind, pv.shape) == (jv.kind, tuple(jv.shape)), path
            assert not pv.data.requires_grad
    assert sorted(wrapped) == sorted(DEFAULT_TARGETS[:4])
    base_kind = {"QL+Q8": QTensor, "L": torch.Tensor}[label]
    assert isinstance(pn["blocks/pos0/mix/wq"].base, base_kind)
    assert isinstance(pn["embed"], base_kind)
    opt = dict(tree_paths(pstate["opt"]["m"]))
    assert len(opt) == 2 * 4 and all(p.endswith(("/a", "/b")) for p in opt)


def test_split_and_merge_round_trip(ref_state):
    """``split_trainable`` gives the reference's trainable tree (adapter
    dicts, None elsewhere, QTensors of None fields), and
    ``merge_trainable`` puts back the very same objects."""
    label, jstate = ref_state
    pstate = train_state_from_jax(jstate, "cpu")
    params = pstate["params"]
    tr, fr = split_trainable(params)
    jtr, _ = jlora.split_trainable(jstate["params"])
    assert [p for p, _ in tree_paths(tr)] == list(_ref_paths(jtr))
    assert all(t.requires_grad for _, t in tree_paths(tr))
    back = merge_trainable(tr, fr)
    for (pa, a), (pb, b) in zip(tree_paths(back), tree_paths(params)):
        assert pa == pb and a is b
    if label == "QL+Q8":
        assert isinstance(tr["embed"], QTensor) and tr["embed"].data is None
    assert split_trainable({"w": torch.ones(2, 2)})[1] is None


# --------------------------------------------------------------------------
# dense dispatch
# --------------------------------------------------------------------------


def _dense_cases():
    rng = np.random.default_rng(3)

    def bf(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(jnp.bfloat16)

    x = bf(2, 5, 64)
    h = (rng.standard_normal((2, 5, 128))).astype(np.float32)
    o = bf(2, 5, 4, 16)
    return {
        # name: (x, (kind, weight[, a, b]), n_in, bias, out_dtype)
        "wq int8 f32 out": (x, ("int8", bf(64, 4, 16, scale=0.125)), 1,
                            bf(4, 16), "f32"),
        "wo int8 n_in=2": (o, ("int8", bf(4, 16, 64, scale=0.125)), 2,
                           None, None),
        "w_down int8 f32 x": (h, ("int8", bf(128, 64, scale=0.09)), 1,
                              None, None),
        "wq nf4": (x, ("nf4", bf(64, 4, 16, scale=0.125)), 1, None, None),
        "wq LoRA int8": (x, ("lora-int8", bf(64, 4, 16, scale=0.125),
                             bf(64, 3, scale=0.1), bf(3, 4, 16, scale=0.1)),
                         1, bf(4, 16), "f32"),
        "wo LoRA bf16": (o, ("lora", bf(4, 16, 64, scale=0.125),
                             bf(4, 16, 3, scale=0.1), bf(3, 64, scale=0.1)),
                         2, None, None),
    }


def _weights(spec):
    kind, w, *ab = spec
    jw, tw = jnp.asarray(w), from_jax_numpy(w)
    if kind in ("int8", "lora-int8"):
        jw, tw = jq.quantize_int8(jw), quantize_int8(tw)
    elif kind == "nf4":
        jw, tw = jq.quantize_nf4(jw), quantize_nf4(tw)
    if kind.startswith("lora"):
        a, b = ab
        jw = jlora.LoRATensor(jw, jnp.asarray(a), jnp.asarray(b),
                              scaling=2.0)
        tw = LoRATensor(tw, from_jax_numpy(a), from_jax_numpy(b),
                        scaling=2.0)
    return jw, tw


@pytest.mark.parametrize("name", list(_dense_cases()))
def test_dense_dispatch_matches_the_reference(name):
    """``qmm_impl="ref"`` is the reference's ``dense``: f32 outputs to f32
    summation order (2e-5 relative to the output's scale), bf16 within one
    ulp. ``"kernel"`` keeps the dequantized weight in f32: it equals the
    f32 product exactly and the reference within the weights' bf16
    rounding (2^-9 relative each: under 1% of the output's scale)."""
    x, spec, n_in, bias, out = _dense_cases()[name]
    jw, tw = _weights(spec)
    jout = jnp.float32 if out == "f32" else None
    tout = torch.float32 if out == "f32" else None
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else from_jax_numpy(bias)
    want = np.asarray(JL.dense(jnp.asarray(x), jw, n_in=n_in, bias=jb,
                               out_dtype=jout), np.float32)
    tx = from_jax_numpy(x)
    scale = float(np.abs(want).max())
    got = {impl: L.dense(tx, tw, n_in=n_in, bias=tb, out_dtype=tout,
                         qmm_impl=impl) for impl in ("ref", "kernel")}
    for impl, y in got.items():
        assert y.dtype == {"f32": torch.float32}.get(out, tx.dtype), impl
        assert tuple(y.shape) == want.shape, impl
    ref = got["ref"].float().numpy()
    if got["ref"].dtype == torch.float32:
        np.testing.assert_allclose(ref, want, rtol=0, atol=2e-5 * scale)
    else:
        np.testing.assert_allclose(ref, want, rtol=2 ** -7, atol=1e-6)
    kern = got["kernel"].float().numpy()
    np.testing.assert_allclose(kern, want, rtol=0, atol=1e-2 * scale)
    if spec[0] == "int8" and bias is None:
        w32 = tw.dequantize(torch.float32)
        exact = L.dense(tx.float(), w32, n_in=n_in).to(got["kernel"].dtype)
        assert torch.equal(got["kernel"], exact)


# --------------------------------------------------------------------------
# loss and adapter gradients
# --------------------------------------------------------------------------


def _ref_loss_and_grads(jstate, label, batch):
    cfg = get_config(ARCH, reduced=True)
    jm = JLM(cfg)
    tr, fr = jlora.split_trainable(
        jax.tree_util.tree_map(jnp.asarray, jstate["params"]))
    (loss, _), g = jax.value_and_grad(
        lambda t: jm.loss(jlora.merge_trainable(t, fr), _jbatch(batch)),
        has_aux=True)(tr)
    return float(loss), _ref_paths(jax.device_get(g))


def _port_loss_and_grads(jstate, label, batch, qmm_impl):
    model = make_model(port_config(ARCH, reduced=True), _ptech(label),
                       device="cpu", qmm_impl=qmm_impl)
    params = train_state_from_jax(jstate, "cpu")["params"]
    paths = tree_paths(split_trainable(params)[0])
    loss, _ = model.loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, [t for _, t in paths])
    return float(loss.detach()), {p: g for (p, _), g in zip(paths, grads)}


@pytest.mark.parametrize("qmm_impl", ["ref", "kernel"])
def test_loss_and_adapter_grads_match_the_reference(ref_state, batch,
                                                    qmm_impl):
    label, jstate = ref_state
    jl, jg = _ref_loss_and_grads(jstate, label, batch)
    before = qmm.LAUNCHES["int8_matmul"]
    pl, pg = _port_loss_and_grads(jstate, label, batch, qmm_impl)
    assert qmm.LAUNCHES["int8_matmul"] == before     # the CPU launches none
    loss_tol, cos_tol = ((LOSS_ATOL, GRAD_COS) if qmm_impl == "ref"
                         else (KERNEL_LOSS_ATOL, KERNEL_GRAD_COS))
    assert abs(pl - jl) < loss_tol
    assert pg.keys() == jg.keys() and len(pg) == 8
    for path, g in pg.items():
        assert g.dtype == torch.bfloat16
        assert _cos(g.float().numpy(), np.asarray(jg[path], np.float32)) \
            >= cos_tol, path


def test_kernel_route_differs_from_ref_by_the_weight_rounding(batch):
    """On an int8 base the two routes differ (each weight rounded to bf16
    or not); on a bf16 base there is no int8 weight and they agree bit
    for bit."""
    cfg = get_config(ARCH, reduced=True)
    out = {}
    for label in LABELS:
        jstate = _set_b(jax.device_get(jinit(
            JLM(cfg), _jtech(label), jax.random.PRNGKey(0))[0]))
        out[label] = [_port_loss_and_grads(jstate, label, batch, impl)[0]
                      for impl in ("ref", "kernel")]
    assert out["L"][0] == out["L"][1]
    assert out["QL+Q8"][0] != out["QL+Q8"][1]


# --------------------------------------------------------------------------
# whole train steps
# --------------------------------------------------------------------------


def test_three_steps_match_the_reference(ref_state, batch):
    """Three steps from one bridged state at lr 5e-3 on a fixed batch,
    the port's qmm_impl="ref" against the reference's jitted step. Frozen
    leaves (the int8 or bf16 base, embed, norms, biases) are bit-unchanged
    on both sides. Step 1 agrees to LOSS_ATOL and 1% in grad_norm; later
    steps, where Adam's sign-like steps amplify one-ulp differences, to
    1e-2 and 3% (tests/test_torch_train.py's band); the adapters after
    step 3 differ by under half their own update, in its direction."""
    label, jstate = ref_state
    cfg = get_config(ARCH, reduced=True)
    jm = JLM(cfg)
    jcfg = jopt.AdamWConfig(lr=5e-3, warmup=0)
    tech = _jtech(label)
    jstep = jax.jit(jbuild(jm, tech, make_shard_ctx(cfg, tech, None), jcfg))
    model = make_model(port_config(ARCH, reduced=True), _ptech(label),
                       device="cpu", qmm_impl="ref")
    pstate = train_state_from_jax(jstate, "cpu")
    pstep = build_train_step(model, _ptech(label),
                             topt.AdamWConfig(lr=5e-3, warmup=0))
    js = jax.tree_util.tree_map(jnp.asarray, jstate)
    for i in range(3):
        js, jm_ = jstep(js, _jbatch(batch))
        pstate, pm = pstep(pstate, _tbatch(batch))
        loss_tol, norm_tol = (LOSS_ATOL, 0.01) if i == 0 else (1e-2, 0.03)
        assert abs(float(pm["loss"]) - float(jm_["loss"])) < loss_tol, i
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=norm_tol), i
    assert int(pstate["step"]) == int(js["step"]) == 3
    p0 = _ref_paths(jstate["params"])
    want = _ref_paths(jax.device_get(js["params"]))
    got = dict(tree_paths(to_numpy(pstate["params"])))
    assert got.keys() == want.keys() == p0.keys()
    for path, w in want.items():
        start = np.asarray(p0[path])
        if not path.endswith(("/a", "/b")):
            for side in (np.asarray(w), np.asarray(got[path])):
                assert side.tobytes() == start.tobytes(), path
            continue
        w32, g32 = np.asarray(w, np.float32), np.asarray(got[path],
                                                         np.float32)
        upd = w32 - start.astype(np.float32)
        assert np.linalg.norm(g32 - w32) < 0.5 * np.linalg.norm(upd), path
        assert _cos(g32 - start.astype(np.float32), upd) >= 0.9, path


@pytest.mark.parametrize("label", ["QL", "Q8", "Q", "L+Q"])
def test_unported_quant_techniques_raise(label):
    """LoRA on an nf4 base (the reference's apply_lora caveat: ``QL``,
    ``L+Q``) raises, naming its ROADMAP item. Quantized full training
    (``Q8``, ``Q``) is ported: it builds 8-bit moments and takes a step
    that moves codes (tests/test_torch_quant_train.py holds it against the
    reference)."""
    model = make_model(port_config(ARCH, reduced=True), _ptech(label),
                       device="cpu")
    if label in ("QL", "L+Q"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_train_state(model, _ptech(label))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_train_step(model, _ptech(label), topt.AdamWConfig())
        return
    state, opt = init_train_state(model, _ptech(label))
    assert opt.state_bits == 8
    wq = state["params"]["blocks"]["pos0"]["mix"]["wq"]
    assert isinstance(wq, QTensor) and wq.kind == (
        "int8" if label == "Q8" else "nf4")
    before = [t.clone() for _, t in tree_paths(state["params"])
              if not t.is_floating_point()]
    step = build_train_step(model, _ptech(label), topt.AdamWConfig(
        lr=5e-3, warmup=0, state_bits=8))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, 512, (2, 16), dtype=np.int32))
    state, met = step(state, {"tokens": toks, "labels": toks})
    assert np.isfinite(float(met["loss"]))
    after = [t for _, t in tree_paths(state["params"])
             if not t.is_floating_point()]
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_train_cli_fine_tunes_on_an_int8_base(capsys, keep_sigterm):
    qmm.LAUNCHES.clear()
    train_cli.main(["--reduced", "--device", "cpu", "--technique", "QL+Q8",
                    "--steps", "2", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("QL+Q8: ") and "trainable of" in lines[0]
    n_train, n_total = (int(w) for w in lines[0].split()
                        if w.isdigit())
    assert 0 < n_train < n_total
    assert "step      2  loss" in out
    assert qmm.LAUNCHES["int8_matmul"] == 0
