"""Quantized full training (``Q``: nf4, ``Q8``: int8, no peft) and the
8-bit block-wise AdamW moments against the JAX package, at the reduced
qwen1.5-0.5b size, on the same numpy inputs and bridged state.

``Opt8`` codes: the reference divides each block's absmax by 127.0, the
port multiplies by the f32 reciprocal (the repo lint's NUM-01), so a
scale may sit one f32 ulp off and move a code at a rounding tie by one.

Whole steps are held from the reference's own state (bridged before each
step), not free-running: an 8-bit second moment whose block's absmax
rounds it to code 0 leaves AdamW dividing a nonzero first moment by
sqrt((1 - b2) g^2), so an element whose gradient falls toward zero takes
a step many times lr, a row's absmax (and with it every code of the row)
jumps at requantization, and which elements hit this depends on the
gradients' last bits. The reference's own trajectory blows up so at step
3 (loss 6.3 -> 24.5 at lr 5e-3), the port's at step 3 or 4; with the
frameworks' gradients a roundoff apart, free-running trajectories part.
So each step is held: the loss and grad_norm at the limits of
tests/test_torch_train.py, the moments' direction, and after the first
step (zero moments: nothing decodes to zero) the params as the F+R test
holds them; and the optimizer with the requantization, fed the
reference's own gradients, equal to the reference's to the last code."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import technique_from_label as jtech
from repro.models.lm import LM as JLM
from repro.parallel.sharding import make_shard_ctx
from repro.train import optimizer as jopt
from repro.train.step import build_train_step as jbuild
from repro.train.step import dequant_tree as jdequant
from repro.train.step import init_train_state as jinit
from repro.train.step import requant_like as jrequant
from repro_torch.bridge import from_jax_numpy, train_state_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.core.config import ShapeSpec, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.launch.build import make_model
from repro_torch.models.params import tree_paths
from repro_torch.quant.qtensor import QTensor, quantize_int8, quantize_nf4
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from test_torch_train import GRAD_COS, LOSS_ATOL, keep_sigterm  # noqa: F401

ARCH = "qwen1.5-0.5b"
B, T = 2, 64
LR = 5e-3                 # tests/test_torch_train.py's three-step lr


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, (B, T), dtype=np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    lab[0, :5] = -1
    return cfg, {"tokens": tok, "labels": lab}


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _check_codes(got, want, scale_got, scale_want, steps: int = 1):
    """Opt8 codes within one of the reference's. One encode puts a scale
    at most one f32 ulp off (the reciprocal multiply; measured over
    12,800 random blocks: at most 1), which moves a code only at a
    rounding tie, and there by one: after one encode a code differs only
    where its block's scale does. Over ``steps`` steps each decode carries
    the last step's differences on: a code one off moves the next absmax
    by at most one code of the last scale (measured: 1,756 ulps, 2e-4
    relative, at step 3 of the Q cycle), so scales are held to ``steps``
    ulps plus 2 / 127 of the scale a step after the first."""
    sg, sw = np.asarray(scale_got, np.float32), np.asarray(scale_want,
                                                           np.float32)
    bound = steps * np.spacing(np.abs(sw)) + (steps - 1) * 2 / 127 * np.abs(
        sw)
    assert np.all(np.abs(sg - sw) <= bound), "scales"
    d = np.asarray(got, np.int32) - np.asarray(want, np.int32)
    assert np.all(np.abs(d) <= 1)
    off = (d != 0).any(-1)
    if steps == 1:
        assert np.all(sg[off] != sw[off])
    return int((d != 0).sum())


# --------------------------------------------------------------------------
# Opt8 codec and the 8-bit AdamW
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((3, 300), 1e-3),
                                         ((256,), 50.0), ((7, 5, 9), 1.0),
                                         ((2, 256), 0.0)])
def test_o8_codec_matches_the_reference(shape, scale):
    x = (np.random.default_rng(3).standard_normal(shape) * scale).astype(
        np.float32)
    want = jopt._o8_encode(jnp.asarray(x))
    got = topt._o8_encode(torch.from_numpy(x))
    assert got.shape == tuple(want.shape) == shape
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.q.shape) == want.q.shape
    _check_codes(got.q.numpy(), np.asarray(want.q), got.scale.numpy(),
                 np.asarray(want.scale))
    back = topt._o8_decode(got).numpy()
    ref_back = np.asarray(jopt._o8_decode(want))
    assert back.shape == shape
    # a code one off decodes one scale apart
    assert np.all(np.abs(back - ref_back)
                  <= np.repeat(np.asarray(want.scale), 256)[:x.size]
                  .reshape(shape) * (1 + 1e-6))


def test_o8_codes_split_only_at_ties():
    """Blocks built to put values exactly on the reference's ties: each
    code either equals the reference's or sits one off where the scales
    differ by one ulp."""
    rng = np.random.default_rng(9)
    s = (rng.uniform(0.5, 2.0, 64) / 127.0).astype(np.float32)
    codes = rng.integers(-126, 126, (64, 256)).astype(np.float32) + 0.5
    x = (codes * s[:, None]).astype(np.float32)
    x[:, 0] = 127 * s                       # the absmax
    want = jopt._o8_encode(jnp.asarray(x.ravel()))
    got = topt._o8_encode(torch.from_numpy(x.ravel()))
    n_off = _check_codes(got.q.numpy(), np.asarray(want.q),
                         got.scale.numpy(), np.asarray(want.scale))
    assert n_off < got.q.numel()


def test_opt8_blockwise_moments():
    """Mirrors tests/test_substrate.py::test_opt8_blockwise_moments."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    rec = topt._o8_decode(topt._o8_encode(x))
    assert float((rec - x).abs().max()) < 0.05


@pytest.mark.parametrize("master", [False, True])
def test_adamw8_matches_the_reference(master):
    """Three 8-bit updates from the same f32 gradients on bf16 and f32
    leaves of rank 1-3, in place on the port's side: codes as the codec
    test holds them, params equal or one bf16 ulp apart."""
    rng = np.random.default_rng(1)
    shapes = {"w": (3, 8, 40), "ln": (8,), "b": {"x": (5, 2)}}

    def draw(tree, dtype):
        if isinstance(tree, dict):
            return {k: draw(v, dtype) for k, v in tree.items()}
        return rng.standard_normal(tree).astype(dtype)

    params = draw(shapes, np.float32)
    params["w"] = params["w"].astype(jnp.bfloat16)
    grads = [draw(shapes, np.float32) for _ in range(3)]
    kw = dict(lr=1e-2, warmup=2, decay_steps=10, master_fp32=master,
              state_bits=8)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init_opt_state(jcfg, jp)
    tp = from_jax_numpy(params)
    tstate = topt.init_opt_state(tcfg, tp)
    assert isinstance(tstate["m"]["w"], topt.Opt8)
    for k, g in enumerate(grads, 1):
        jp, jstate = jopt.adamw_apply(
            jcfg, jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        topt.adamw_apply(tcfg, from_jax_numpy(g), tstate, tp)
        for nm in ("m", "v"):
            want = dict(tree_paths(from_jax_numpy(jax.device_get(
                jstate[nm]))))
            got = dict(tree_paths(tstate[nm]))
            assert got.keys() == want.keys()
            for path in want:
                if path.endswith("/q"):
                    base = path[:-2]
                    _check_codes(got[path].numpy(), want[path].numpy(),
                                 got[base + "/scale"].numpy(),
                                 want[base + "/scale"].numpy(), steps=k)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    want = dict(tree_paths(from_jax_numpy(jax.device_get(jp))))
    for path, g in tree_paths(tp):
        w = want[path]
        tol = (dict(rtol=8e-3, atol=0) if w.dtype == torch.bfloat16
               else dict(rtol=2e-5, atol=2e-5))
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   err_msg=path, **tol)


# --------------------------------------------------------------------------
# the dequant-train-requant cycle
# --------------------------------------------------------------------------


def _code_diff(got: QTensor, want: QTensor) -> np.ndarray:
    """|code difference| per weight (nf4: per 4-bit code)."""
    g, w = got.data.numpy().astype(np.int32), want.data.numpy().astype(
        np.int32)
    if got.kind == "int8":
        return np.abs(g - w)
    return np.maximum(np.abs((g >> 4) - (w >> 4)), np.abs((g & 15) -
                                                          (w & 15)))


@pytest.mark.parametrize("label", ["Q8", "Q"])
def test_optimizer_and_requant_match_the_reference_on_its_gradients(
        setup, label):
    """Three steps of AdamW on the dequantized view, then the
    requantization, each fed the reference's own gradient of its own
    view: the port's params equal the reference's code for code and scale
    for scale, and the 8-bit moments as the codec test holds them
    (measured: at most 9 codes of 116,224 one off a step)."""
    cfg, batch = setup
    jm = JLM(cfg)
    jcfg = jopt.AdamWConfig(lr=LR, warmup=0, state_bits=8)
    js, _ = jinit(jm, jtech(label), jax.random.PRNGKey(0), jcfg)
    ps = train_state_from_jax(jax.device_get(js), "cpu")
    tcfg = topt.AdamWConfig(lr=LR, warmup=0, state_bits=8)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    grad_fn = jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))
    for k in range(1, 4):
        view = jdequant(js["params"])
        g = grad_fn(view)
        newp, newo = jopt.adamw_apply(jcfg, g, js["opt"], view)
        js = {"params": jrequant(newp, js["params"]), "opt": newo}
        tview = tstep.dequant_tree(ps["params"])
        topt.adamw_apply(tcfg, from_jax_numpy(jax.device_get(g)),
                         ps["opt"], tview)
        tstep.requant_like(tview, ps["params"])
        want = from_jax_numpy(jax.device_get(js))
        is_q = lambda x: isinstance(x, QTensor)          # noqa: E731
        wq = dict(tree_paths(want["params"], is_leaf=is_q))
        for path, leaf in tree_paths(ps["params"], is_leaf=is_q):
            w = wq[path]
            if is_q(leaf):
                assert leaf.kind == w.kind
                assert _code_diff(leaf, w).max() == 0, path
                for a, b in zip(tree_paths(leaf), tree_paths(w)):
                    assert torch.equal(a[1], b[1]), path
            else:
                assert torch.equal(leaf.detach(), w), path
        for nm in ("m", "v"):
            wm = dict(tree_paths(want["opt"][nm]))
            gm = dict(tree_paths(ps["opt"][nm]))
            for path in wm:
                if path.endswith("/q"):
                    base = path[:-2]
                    _check_codes(gm[path].numpy(), wm[path].numpy(),
                                 gm[base + "/scale"].numpy(),
                                 wm[base + "/scale"].numpy(), steps=k)


@pytest.mark.parametrize("label", ["Q8", "Q"])
def test_three_steps_match_the_reference(setup, label, monkeypatch):
    """Three steps, each from the reference's state bridged, at the F+R
    test's limits: step 1's loss within LOSS_ATOL and grad_norm within 1%,
    later steps' within 1e-2 and 3% (the reference's state after step 2
    carries rows the 8-bit moments blew up, loss 5.6 -> 8.8 for Q8, where
    the two read 4.6e-3 apart); the
    decoded moments' direction (cosine >= GRAD_COS per leaf), the new
    codes those of ``quantize_int8``/``quantize_nf4`` of the port's
    updated view, bitwise; after the first step the dequantized params
    within half the reference's update of it, in its direction (cosine >=
    0.9), as tests/test_torch_train.py holds F+R."""
    cfg, batch = setup
    tech = jtech(label)
    jm = JLM(cfg, attn_impl="naive", remat=tech.remat)
    jcfg = jopt.AdamWConfig(lr=LR, warmup=0, state_bits=8)
    js, _ = jinit(jm, tech, jax.random.PRNGKey(0), jcfg)
    jstep = jax.jit(jbuild(jm, tech, make_shard_ctx(cfg, tech, None), jcfg))
    ptech = technique_from_label(label)
    model = make_model(port_config(ARCH, reduced=True), ptech, device="cpu")
    pstep = tstep.build_train_step(
        model, ptech, topt.AdamWConfig(lr=LR, warmup=0, state_bits=8))
    views = []
    orig = tstep.requant_like

    def recorded(view, like):
        views.append({p: t.detach().clone() for p, t in tree_paths(view)})
        orig(view, like)

    monkeypatch.setattr(tstep, "requant_like", recorded)
    is_q = lambda x: isinstance(x, QTensor)              # noqa: E731
    for i in range(3):
        start = jax.device_get(js)
        ps = train_state_from_jax(start, "cpu")
        js, jm_ = jstep(js, jax.tree_util.tree_map(jnp.asarray, batch))
        ps, pm = pstep(ps, _tbatch(batch))
        loss_tol, norm_tol = (LOSS_ATOL, 0.01) if i == 0 else (1e-2, 0.03)
        assert abs(float(pm["loss"]) - float(jm_["loss"])) < loss_tol, i
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=norm_tol), i
        view = views[-1]
        for path, leaf in tree_paths(ps["params"], is_leaf=is_q):
            if not is_q(leaf):
                continue
            q = (quantize_int8(view[path]) if leaf.kind == "int8" else
                 quantize_nf4(view[path], stacked=leaf.data.ndim == 2))
            for (_, a), (_, b) in zip(tree_paths(leaf), tree_paths(q)):
                assert torch.equal(a, b), path
        after = from_jax_numpy(jax.device_get(js))
        for nm in ("m", "v"):
            want = dict(tree_paths(after["opt"][nm]))
            got = dict(tree_paths(ps["opt"][nm]))
            for path in want:
                if path.endswith("/q"):
                    base = path[:-2]
                    dec = [(t[path].float() * t[base + "/scale"][:, None])
                           for t in (got, want)]
                    assert _cos(dec[0], dec[1]) >= GRAD_COS, (i, nm, path)
        if i:
            continue
        p0 = dict(tree_paths(tstep.dequant_tree(
            from_jax_numpy(start["params"]))))
        w1 = dict(tree_paths(tstep.dequant_tree(after["params"])))
        g1 = dict(tree_paths(tstep.dequant_tree(ps["params"])))
        for path, w in w1.items():
            upd = (w.float() - p0[path].float()).numpy()
            got = (g1[path].detach().float() - p0[path].float()).numpy()
            if not upd.any():
                assert not got.any(), path
                continue
            assert np.linalg.norm(got - upd) < 0.5 * np.linalg.norm(upd), \
                path
            assert _cos(got, upd) >= 0.9, path


@pytest.mark.parametrize("label", ["Q", "Q8", "Q+F+R", "Q8+F+R"])
def test_trainer_runs_quantized_full_training(label, keep_sigterm):  # noqa: F811
    """``Trainer`` on the CPU: the params stay ``QTensor``s whose codes
    move, the moments are 8-bit (about 1/4 + 1/256 of f32's bytes), the
    losses finite, and the int8 kernel is not on this path (the view is
    bf16)."""
    cfg = port_config(ARCH, reduced=True)
    qmm.LAUNCHES.clear()
    tr = Trainer(cfg, ShapeSpec("cli", 32, 2, "train"),
                 technique_from_label(label),
                 TrainerConfig(steps=2, log_every=1),
                 topt.AdamWConfig(lr=5e-3, warmup=0, state_bits=8),
                 device="cpu")
    is_q = lambda x: isinstance(x, QTensor)              # noqa: E731
    before = {p: t.data.clone() for p, t in tree_paths(
        tr.state["params"], is_leaf=is_q) if is_q(t)}
    assert before and all(
        t.kind == ("nf4" if label.startswith("Q+") or label == "Q"
                   else "int8")
        for _, t in tree_paths(tr.state["params"], is_leaf=is_q) if is_q(t))
    out = tr.run()
    assert out["final_step"] == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    now = dict(tree_paths(tr.state["params"], is_leaf=is_q))
    assert all(not torch.equal(now[p].data, d) for p, d in before.items())
    o8 = [v for _, v in tree_paths(tr.state["opt"]["m"], is_leaf=lambda x:
                                   isinstance(x, topt.Opt8))]
    assert o8 and all(isinstance(v, topt.Opt8) for v in o8)
    n = sum(np.prod(v.shape) for v in o8)
    nbytes = sum(v.q.numel() + 4 * v.scale.numel() for v in o8)
    assert nbytes / (4 * n) == pytest.approx(1 / 4 + 1 / 256, rel=0.05)
    assert qmm.LAUNCHES["int8_matmul"] == 0


def test_default_moments_are_8_bit_only_for_quantized_full_training():
    for label, bits in (("Q8", 8), ("Q", 8), ("QL+Q8", 32), ("F+R", 32)):
        assert tstep.default_opt_cfg(
            technique_from_label(label)).state_bits == bits
    with pytest.raises(ValueError, match="state_bits"):
        topt.init_opt_state(topt.AdamWConfig(state_bits=4),
                            {"w": torch.zeros(3)})
