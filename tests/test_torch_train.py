"""The port's training slice against the JAX package on the same numpy
inputs and the same bridged weights, at the reduced qwen1.5-0.5b size:
data, optimizer, loss and gradients, whole train steps, and the
launcher. The model is bf16, so the two frameworks' f32 sums in
different orders round some activations and logits one bf16 ulp apart;
each tolerance below says what that allows."""
import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import technique_from_label as jtech
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.lm import LM as JLM
from repro.parallel.sharding import make_shard_ctx
from repro.train import optimizer as jopt
from repro.train.step import build_train_step as jbuild
from repro.train.step import init_train_state as jinit
from repro_torch.bridge import from_jax_numpy, to_numpy, train_state_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.core.config import Technique, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import train as train_cli
from repro_torch.launch.build import make_model
from repro_torch.models.lm import LM
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.train import optimizer as topt
from repro_torch.train.remat import remat_extra_flops_factor
from repro_torch.train.step import build_train_step, init_train_state

ARCH = "qwen1.5-0.5b"
B, T = 2, 64
# The loss is a mean over bf16-rounded logits: a one-ulp split of many
# logits moves it by ~1e-3 at most here (measured: 4.2e-4 naive, 7e-6
# flash); gradients keep their direction.
LOSS_ATOL = 2e-3
GRAD_COS = 0.999


@pytest.fixture(scope="module")
def jax_setup():
    cfg = get_config(ARCH, reduced=True)
    params = jax.device_get(JLM(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, (B, T), dtype=np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    lab[0, :5] = -1                       # masked labels
    return cfg, params, {"tokens": tok, "labels": lab}


@pytest.fixture
def keep_sigterm():
    """Trainer installs a SIGTERM handler; put the worker's back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _grad_params(params):
    return tree_map(lambda t: t.requires_grad_(True), from_jax_numpy(params))


# --------------------------------------------------------------------------
# data and optimizer: exact or to f32 rounding
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(pack=False),
                                dict(n_hosts=2, host_id=1, seed=3)])
def test_synthetic_batches_equal_the_reference_bitwise(kw):
    base = dict(vocab_size=512, seq_len=96, global_batch=4, mean_doc_len=40)
    port = SyntheticLM(DataConfig(**base, **kw))
    ref = JSyntheticLM(JDataConfig(**base, **kw))
    for step in (0, 1, 7):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_schedule_matches_the_reference():
    cfg = dict(lr=3e-4, warmup=10, decay_steps=50, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 33, 60, 100):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg),
                                   jnp.asarray(step, jnp.int32)))
        got = float(topt.schedule(topt.AdamWConfig(**cfg),
                                  torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_matches_the_reference(master):
    """Three updates from the same f32 gradients on bf16 and f32 leaves of
    rank 1-3 (decay only on rank >= 2), in place on the port's side."""
    rng = np.random.default_rng(1)
    shapes = {"w": (3, 8, 4), "ln": (8,), "b": {"x": (5, 2)}}

    def draw(shape_tree, dtype):
        if isinstance(shape_tree, dict):
            return {k: draw(v, dtype) for k, v in shape_tree.items()}
        return rng.standard_normal(shape_tree).astype(dtype)

    params = draw(shapes, np.float32)
    params["w"] = params["w"].astype(jnp.bfloat16)
    grads = [draw(shapes, np.float32) for _ in range(3)]
    kw = dict(lr=1e-2, warmup=2, decay_steps=10, master_fp32=master)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init_opt_state(jcfg, jp)
    tp = from_jax_numpy(params)
    tstate = topt.init_opt_state(tcfg, tp)
    for g in grads:
        jp, jstate = jopt.adamw_apply(
            jcfg, jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        topt.adamw_apply(tcfg, from_jax_numpy(g), tstate, tp)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    got = dict(tree_paths(to_numpy({"p": tp, "m": tstate["m"],
                                    "v": tstate["v"],
                                    **({"mw": tstate["master"]}
                                       if master else {})})))
    want = dict(tree_paths(jax.device_get(
        {"p": jp, "m": jstate["m"], "v": jstate["v"],
         **({"mw": jstate["master"]} if master else {})})))
    assert got.keys() == want.keys()
    for path, w in want.items():
        # bf16 leaves may land one bf16 ulp apart after the final cast
        tol = (dict(rtol=8e-3, atol=0) if w.dtype == jnp.bfloat16
               else dict(rtol=2e-5, atol=2e-5))
        np.testing.assert_allclose(np.asarray(got[path], np.float32),
                                   np.asarray(w, np.float32), err_msg=path,
                                   **tol)


def test_train_state_bridges_bitwise(jax_setup):
    cfg, _, _ = jax_setup
    tech = jtech("Naive")
    state, _ = jinit(JLM(cfg), tech, jax.random.PRNGKey(0),
                     jopt.AdamWConfig(master_fp32=True))
    state = jax.device_get(state)
    port = train_state_from_jax(state, "cpu")
    assert all(t.requires_grad for _, t in tree_paths(port["params"]))
    assert port["step"].shape == () and port["opt"]["step"].shape == ()
    back = dict(tree_paths(to_numpy(port)))
    want = dict(tree_paths(state))
    assert back.keys() == want.keys()
    for path, a in want.items():
        b = back[path]
        assert b.dtype == np.asarray(a).dtype and b.shape == np.shape(a)
        np.testing.assert_array_equal(
            np.atleast_1d(b).view(np.uint8),
            np.atleast_1d(np.asarray(a)).view(np.uint8), err_msg=path)


# --------------------------------------------------------------------------
# the loss and its gradient
# --------------------------------------------------------------------------


@pytest.mark.parametrize("jax_impl,port_impl", [("naive", "naive"),
                                                ("pallas", "flash")])
def test_loss_and_grads_match_the_reference(jax_setup, jax_impl, port_impl):
    cfg, params, batch = jax_setup
    jm = JLM(cfg, attn_impl=jax_impl)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree_util.tree_map(jnp.asarray, batch)),
        has_aux=True)(params)
    model = LM(port_config(ARCH, reduced=True), attn_impl=port_impl,
               device="cpu")
    tp = _grad_params(params)
    tl, tmet = model.loss(tp, _tbatch(batch))
    paths = tree_paths(tp)
    tg = torch.autograd.grad(tl, [t for _, t in paths])
    assert abs(float(tl.detach()) - float(jl)) < LOSS_ATOL
    assert abs(float(tmet["ce"]) - float(jmet["ce"])) < LOSS_ATOL
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    want = dict(tree_paths(jax.device_get(jg)))
    for (path, _), g in zip(paths, tg):
        assert g.dtype == torch.bfloat16
        assert _cos(g.float().numpy(), np.asarray(want[path], np.float32)) \
            >= GRAD_COS, path


def test_loss_masks_labels_and_covers_the_padded_vocab(jax_setup):
    """All-masked rows give 0 tokens and loss 0; the logsumexp runs over
    all padded columns, so a change to a padding row of the tied
    embedding moves the loss."""
    cfg, params, batch = jax_setup
    model = LM(port_config(ARCH, reduced=True), device="cpu")
    tp = from_jax_numpy(params)
    masked = dict(batch, labels=np.full_like(batch["labels"], -1))
    with torch.no_grad():
        loss, met = model.loss(tp, _tbatch(masked))
        assert float(loss) == 0.0 and float(met["ce"]) == 0.0
        base = float(model.loss(tp, _tbatch(batch))[0])
        assert model.vocab > cfg.vocab_size
        tp["embed"][cfg.vocab_size:] = 1.0      # padding rows only
        assert float(model.loss(tp, _tbatch(batch))[0]) != base


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_remat_policies_give_the_same_loss_and_grads(jax_setup, impl):
    """Recomputation changes what is saved, never the arithmetic: none,
    full and selective agree bit for bit on the CPU."""
    _, params, batch = jax_setup
    cfg = port_config(ARCH, reduced=True)
    outs = []
    for remat in ("none", "full", "selective"):
        model = LM(cfg, attn_impl=impl, remat=remat, device="cpu")
        tp = _grad_params(params)
        loss, _ = model.loss(tp, _tbatch(batch))
        grads = torch.autograd.grad(loss, [t for _, t in tree_paths(tp)])
        outs.append((loss.detach(), grads))
    for loss, grads in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        for a, b in zip(grads, outs[0][1]):
            assert torch.equal(a, b)
    assert remat_extra_flops_factor("full") == pytest.approx(4 / 3)
    with pytest.raises(ValueError, match="remat"):
        LM(cfg, remat="sometimes", device="cpu")


# --------------------------------------------------------------------------
# whole train steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("label,jax_impl", [("Naive", "naive"),
                                            ("F+R", "pallas")])
def test_three_steps_match_the_reference(jax_setup, label, jax_impl):
    """Three steps from one bridged state at lr 5e-3 on a fixed batch. The
    port's F is the flash kernel, held against the reference's Pallas
    mode (its builder's own F path, the XLA "chunked" scan, computes the
    same function).

    Tolerances: step 1 agrees to LOSS_ATOL and 1% in grad_norm. Adam
    turns every element's step into about +-lr whatever the gradient's
    size, so where a gradient sits near 0 a one-ulp difference flips that
    element's step, and later steps drift: the reference's own two
    attention paths (pallas, chunked) differ by 3.2e-3 in loss at step 2.
    Later steps are held to 1e-2 in loss and 3% in grad_norm, and the
    params after step 3 to a per-leaf difference under half the leaf's
    own update, with the update's direction kept (cosine >= 0.9)."""
    cfg, _, batch = jax_setup
    tech = jtech(label)
    jm = JLM(cfg, attn_impl=jax_impl, remat=tech.remat)
    jcfg = jopt.AdamWConfig(lr=5e-3, warmup=0)
    jstate, _ = jinit(jm, tech, jax.random.PRNGKey(0), jcfg)
    start = jax.device_get(jstate)
    jstep = jax.jit(jbuild(jm, tech, make_shard_ctx(cfg, tech, None), jcfg))
    ptech = technique_from_label(label)
    model = make_model(port_config(ARCH, reduced=True), ptech, device="cpu")
    assert model.attn_impl == ("flash" if ptech.flash else "naive")
    pstate = train_state_from_jax(start, "cpu")
    pstep = build_train_step(model, ptech, topt.AdamWConfig(lr=5e-3,
                                                            warmup=0))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    for i in range(3):
        jstate, jm_ = jstep(jstate, jb)
        pstate, pm = pstep(pstate, _tbatch(batch))
        loss_tol, norm_tol = (LOSS_ATOL, 0.01) if i == 0 else (1e-2, 0.03)
        assert abs(float(pm["loss"]) - float(jm_["loss"])) < loss_tol, i
        assert float(pm["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=norm_tol), i
    assert int(pstate["step"]) == int(jstate["step"]) == 3
    p0 = dict(tree_paths(start["params"]))
    want = dict(tree_paths(jax.device_get(jstate["params"])))
    for path, got in tree_paths(to_numpy(pstate["params"])):
        w = np.asarray(want[path], np.float32)
        g = np.asarray(got, np.float32)
        upd = w - np.asarray(p0[path], np.float32)
        if not upd.any():
            assert np.array_equal(g, w), path
            continue
        assert np.linalg.norm(g - w) < 0.5 * np.linalg.norm(upd), path
        assert _cos(g - np.asarray(p0[path], np.float32), upd) >= 0.9, path


def test_grad_accum_matches_one_large_batch():
    """Mirrors tests/test_system.py::test_grad_accum_matches_large_batch."""
    cfg = port_config(ARCH, reduced=True)
    model = LM(cfg, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    opt = topt.AdamWConfig(lr=1e-3, warmup=0)
    out = []
    for accum in (1, 2):
        state, _ = init_train_state(model, Technique(), 0, opt)
        step = build_train_step(model, Technique(grad_accum=accum), opt)
        state, met = step(state, batch)
        out.append((state, met))
    (s1, m1), (s2, m2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 0.05
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) \
        < 0.02 * float(m1["grad_norm"])
    a = tree_paths(s1["params"])[1][1].detach().float()
    b = tree_paths(s2["params"])[1][1].detach().float()
    torch.testing.assert_close(a, b, atol=5e-2, rtol=0)


def test_timed_step_is_the_step():
    """With a timer the step records its three layers once each per step
    and computes what the untimed step computes, bit for bit."""
    from repro_torch.core.perfscope import Timer
    cfg = port_config(ARCH, reduced=True)
    tech = technique_from_label("F+R")
    model = make_model(cfg, tech, device="cpu")
    opt = topt.AdamWConfig(lr=1e-3, warmup=0)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    timer = Timer()
    out = []
    for t in (None, timer):
        state, _ = init_train_state(model, tech, 0, opt)
        step = build_train_step(model, tech, opt, timer=t)
        for _ in range(2):
            state, met = step(state, batch)
        out.append((state, met))
    assert {k: v["calls"] for k, v in timer.summary(drop_warmup=0).items()} \
        == {"forward": 2, "backward": 2, "optimizer": 2}
    (s1, m1), (s2, m2) = out
    for k in ("loss", "grad_norm"):
        assert torch.equal(m1[k], m2[k]), k
    for (path, a), (_, b) in zip(tree_paths(s1["params"]),
                                 tree_paths(s2["params"])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("label", ["Naive", "F+R"])
def test_loss_decreases_over_steps(label):
    """Mirrors tests/test_system.py::test_loss_decreases_over_steps."""
    cfg = port_config(ARCH, reduced=True)
    tech = technique_from_label(label)
    model = make_model(cfg, tech, device="cpu")
    opt = topt.AdamWConfig(lr=5e-3, warmup=0, weight_decay=0.0)
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    losses = []
    for _ in range(12):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses
    assert sum(tfa.LAUNCHES.values()) == 0       # the CPU launches nothing


def test_unported_techniques_raise():
    """LoRA on an nf4 base still raises, naming its ROADMAP item;
    sequence parallelism and both attention modes act over a model axis
    and, as in the reference, are no-ops on one device
    (tests/test_torch_tp_train.py holds them over one: the reference's
    sequence, context-parallel, mode builds its state and step here as
    it once refused to); quantized full training (``Q``) now builds its
    state and step (tests/test_torch_quant_train.py holds it), and
    gradient compression is inert, as in the reference's step
    (tests/test_torch_dp_train.py holds the step with it bit for bit to
    the step without it)."""
    model = LM(port_config(ARCH, reduced=True), device="cpu")
    tech = technique_from_label("QL")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_train_state(model, tech)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(model, tech, topt.AdamWConfig())
    for tech in (Technique(sp=True), Technique(attn_mode="head"),
                 Technique(attn_mode="seq")):
        _, opt = init_train_state(model, tech)
        build_train_step(model, tech, opt)
    state, opt = init_train_state(model, technique_from_label("Q"))
    assert opt.state_bits == 8
    assert isinstance(state["opt"]["m"]["embed"], topt.Opt8)
    build_train_step(model, technique_from_label("Q"), opt)


# --------------------------------------------------------------------------
# trainer and launcher
# --------------------------------------------------------------------------


def test_trainer_runs_the_technique_matrix_row(keep_sigterm, tmp_path):
    """F+R+Z3 on one device: Z3 is a no-op, grad_accum 0 resolves to 1;
    with a checkpoint directory it saves every ``checkpoint_every`` steps
    (tests/test_torch_checkpoint.py holds the checkpoints)."""
    cfg = port_config(ARCH, reduced=True)
    from repro_torch.core.config import ShapeSpec
    tech = dataclasses.replace(technique_from_label("F+R+Z3"), grad_accum=0)
    tr = Trainer(cfg, ShapeSpec("cli", 32, 2, "train"), tech,
                 TrainerConfig(steps=3, log_every=1), device="cpu")
    assert tr.technique.grad_accum == 1 and tr.technique.zero_stage == 3
    assert tr.model.attn_impl == "flash" and tr.model.remat == "full"
    out = tr.run()
    assert out["final_step"] == 3 and [h["step"] for h in out["history"]] \
        == [1, 2, 3]
    for h in out["history"]:
        assert set(h) >= {"loss", "ce", "aux", "grad_norm"}
        assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
    assert out["step_ms"] > 0 and out["tokens_per_s"] > 0
    ckpt = Trainer(cfg, ShapeSpec("cli", 32, 2, "train"), tech,
                   TrainerConfig(steps=2, checkpoint_every=1,
                                 checkpoint_dir=str(tmp_path)),
                   device="cpu")
    ckpt.run()
    assert ckpt.ckpt.all_steps() == [1, 2]
    with pytest.raises(ValueError, match="resume"):
        Trainer(cfg, ShapeSpec("cli", 32, 2, "train"), tech,
                TrainerConfig(resume="latest"), device="cpu")


def test_train_cli_runs_on_the_cpu(capsys, keep_sigterm):
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "step      2  loss" in out and "tokens/s" in out
