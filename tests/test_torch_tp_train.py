"""Tensor-parallel training of the port on the CPU: Megatron-style TP and
sequence parallelism over a model axis of gloo ranks, and the 2-D data x
model mesh under ZeRO, on the dense family, held against the port's
one-device step and the reference's.

Placement changes no math (the reference's GSPMD program), so a TP step
is the one-device step up to its order of sums (every seam sums f32
partials and rounds once, the column-parallel inputs' cotangents
included): the step-1 loss and ce within 1e-5
relative and grad_norm within 1e-3, after it each first moment within
2^-5 of its norm and each param within half of its own update and along
it (cosine >= 0.9); the later steps' loss and grad_norm within the
three-step comparisons' 1e-2 and 3% (tests/test_torch_dp_train.py). Teacher forced, the loss of a TP = 2 forward
equals, bit for bit, the one-device forward computed in TP = 2's order
of sums (``torch_tp_train_worker.tp_order``). Each mesh's ranks start
once and run every case in turn (tests/torch_tp_train_worker.py, which
imports no JAX), one intra-op thread each, two meshes' spawns at a
time; the one-device oracles run inside global rank 0 under the same
setting.

Sequence (context-parallel) attention, ``attn_mode="seq"``, is held the
same way: explicit at (1 x 2) with sp off and on (qwen, and chatglm3's
grouped KV), ``"auto"`` turning to it at (1 x 4) on a six-head variant
of the qwen smoke config (the naive attention route), a batch whose T
the degree does not divide (the attention replicated, its gradients not
summed), and Z3 + sp on the (2 x 2) mesh. The GPipe pipeline
(``parallel.pipeline``) runs in the (1 x 2) spawn on the reference
test's stage function and is held to the port's sequential loop bit for
bit and to the reference's ``pipeline_forward`` (run in a subprocess on
two host devices) within 1e-5."""
import dataclasses
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.config import technique_from_label as jtech
from repro.models.lm import LM as JLM
from repro.parallel.sharding import make_shard_ctx as jctx
from repro.train import optimizer as jopt
from repro.train.step import build_train_step as jbuild
from repro.train.step import init_train_state as jinit
from repro_torch.bridge import train_state_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.lm import LM, padded_vocab
from repro_torch.models.params import keystr_paths, tree_map

import torch_tp_train_worker as worker

QWEN, LLAMA, GLM, MAMBA = ("qwen1.5-0.5b", "llama2-7b", "chatglm3-6b",
                           "mamba2-130m")
ARCHS = {"qwen": QWEN, "llama": LLAMA, "glm": GLM}
B, T, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5            # step 1's loss and ce
NORM_RTOL = 1e-3            # grad_norm
MOMENT_REL = 2.0 ** -5      # a first moment's distance over its norm
LOSS_ATOL = 2e-3            # test_torch_dp_train's, against the reference
LATER = (1e-2, 0.03)        # its later steps' loss (abs) and grad_norm


def _batches(seed: int, t: int = T):
    rng = np.random.default_rng(seed)
    vocab = get_config(QWEN, reduced=True).vocab_size
    return [{"tokens": rng.integers(0, vocab, (B, t), dtype=np.int32),
             "labels": rng.integers(0, vocab, (B, t), dtype=np.int32)}
            for _ in range(STEPS)]


BATCHES = _batches(1)
ODD = _batches(2, t=30)     # T = 30: a model axis of 4 does not divide it
SIX = 6                     # heads of the qwen smoke variant at tp 4


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread, as in the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, arch, label, **kw):
    kw.setdefault("batches", BATCHES)
    return (name, "train", dict(arch=arch, label=label, **kw))


def _seq(name, arch, label, **kw):
    return _case(name, arch, label, attn_mode="seq", **kw)


def _plans(start):
    """Each mesh's cases (``(model, data)`` degrees and plan): a (1 x 2)
    mesh (qwen tied and MHA with sp off and on, llama2 untied, mamba2
    folding the model axis, the reference's bridged state), a (1 x 4)
    mesh (chatglm3 smoke, 2 KV heads) and a (2 x 2) mesh (qwen under Z2
    and Z3 with sp); and sequence mode on each, and the pipeline on the
    (1 x 2) mesh."""
    return {
        "tp2": ((2, 1), [
            _case("qwen/oracle", QWEN, "F+R", oracle=True),
            _case("qwen/F+R", QWEN, "F+R"),
            _case("qwen/F+R+sp", QWEN, "F+R", sp=True),
            ("qwen/emulated", "emulate", dict(arch=QWEN, label="F+R",
                                              batches=BATCHES, tp=2,
                                              oracle=True)),
            ("qwen/emulated+sp", "emulate", dict(arch=QWEN, label="F+R",
                                                 batches=BATCHES, tp=2,
                                                 sp=True, oracle=True)),
            _case("llama/oracle", LLAMA, "F", oracle=True),
            _case("llama/F", LLAMA, "F"),
            ("llama/emulated", "emulate", dict(arch=LLAMA, label="F",
                                               batches=BATCHES, tp=2,
                                               oracle=True)),
            _case("mamba/oracle", MAMBA, "F+R", accum=2, oracle=True),
            _case("mamba/F+R+Z3", MAMBA, "F+R+Z3"),
            ("bridged", "train", dict(arch=QWEN, label="F+R", sp=True,
                                      batches=BATCHES[:1], start=start)),
            _seq("qwen/F+R+seq", QWEN, "F+R"),
            _seq("qwen/F+R+seq+sp", QWEN, "F+R", sp=True),
            _case("glm/oracle", GLM, "F+R", oracle=True),
            _seq("glm/F+R+seq", GLM, "F+R"),
            _seq("glm/F+R+seq+sp", GLM, "F+R", sp=True),
            _seq("bridged/seq", QWEN, "F+R", batches=BATCHES[:1],
                 start=start),
            ("pipeline", "pipeline", {})]),
        "tp4": ((4, 1), [_case("glm/oracle", GLM, "F+R", oracle=True),
                         _case("glm/F+R+sp", GLM, "F+R", sp=True),
                         _case("six/oracle", QWEN, "R", heads=SIX,
                               oracle=True),
                         _case("six/R+auto", QWEN, "R", heads=SIX),
                         _case("odd/oracle", QWEN, "F+R", batches=ODD,
                               oracle=True),
                         _seq("odd/F+R+seq", QWEN, "F+R", batches=ODD)]),
        "mesh22": ((2, 2), [
            _case("qwen/oracle", QWEN, "F+R", accum=2, oracle=True),
            _case("qwen/F+R+Z2", QWEN, "F+R+Z2", pieces=True),
            _case("qwen/F+R+Z3+sp", QWEN, "F+R+Z3", sp=True,
                  pieces=True),
            _seq("qwen/F+R+Z3+seq+sp", QWEN, "F+R+Z3", sp=True,
                 pieces=True)]),
    }


# the reference's pipeline on two host devices (its own test skips on
# one): tests/test_substrate.py's stage function on the port's draws
_REF_PIPE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.parallel.pipeline import pipeline_forward, split_stages
d = np.load(sys.argv[1])
w, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])
mesh = jax.make_mesh((2,), ("pipe",))
def stage_fn(p, c):
    def body(h, wl):
        return jnp.tanh(h @ wl), None
    y, _ = jax.lax.scan(body, c, p)
    return y
fn = pipeline_forward(mesh, "pipe", stage_fn, n_micro=x.shape[0])
with mesh:
    out = jax.jit(fn)(split_stages(w, 2), x)
np.save(sys.argv[2], np.asarray(out))
"""


def _ref_pipeline():
    """The reference's ``pipeline_forward`` of the worker's pipeline case
    in a subprocess with two host devices."""
    w, x = worker.pipe_case()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npy")
        np.savez(src, w=w, x=x)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        subprocess.run([sys.executable, "-c", _REF_PIPE, src, dst], env=env,
                       check=True, capture_output=True, timeout=300)
        return np.load(dst)


@pytest.fixture(scope="module")
def runs():
    """Every mesh's ranks, the spawns started two at a time from threads
    of this process, and meanwhile here the reference's seeded qwen
    smoke state and one of its F+R steps (one device, the whole first
    batch). Returns ``{mesh: each rank's results}`` and the reference's
    metrics."""
    cfg = ref_config(QWEN, reduced=True)
    tech = jtech("F+R")
    jm = JLM(cfg, attn_impl="pallas", remat=tech.remat)
    jcfg = jopt.AdamWConfig(lr=5e-3, warmup=0)
    state, _ = jinit(jm, tech, jax.random.PRNGKey(0), jcfg)
    start = tree_map(lambda t: t.detach(), train_state_from_jax(
        jax.device_get(state), "cpu"))
    with ThreadPoolExecutor(3) as ex:
        pipe = ex.submit(_ref_pipeline)
        futures = {name: ex.submit(spawn_ranks, worker.run_all, model,
                                   data=data, backend="gloo", device="cpu",
                                   args=(plan,), threads=1)
                   for name, ((model, data), plan) in _plans(start).items()}
        step = jax.jit(jbuild(jm, tech, jctx(cfg, tech, None), jcfg))
        _, m = step(state, jax.tree_util.tree_map(jnp.asarray, BATCHES[0]))
        ref = {k: float(v) for k, v in m.items()}
        ref["pipeline"] = pipe.result()
        return {name: f.result() for name, f in futures.items()}, ref


@pytest.fixture(scope="module")
def tp2(runs):
    return runs[0]["tp2"]


@pytest.fixture(scope="module")
def tp4(runs):
    return runs[0]["tp4"]


@pytest.fixture(scope="module")
def mesh22(runs):
    return runs[0]["mesh22"]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def _float(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(bits)
    t = t.view(torch.bfloat16) if bits.dtype == np.int16 else \
        t.view(torch.float32)
    return t.float().numpy()


def _cos(a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / n) if n else float(not a.any() and not b.any())


def _holds(got, want, start, what, ce=True):
    """``got`` (a TP run) against ``want`` (the one-device run from the
    same ``start`` params): the module's limits. Adam's first step moves
    an element about lr x sign(g), so an element whose gradient sits
    within the two gradients' difference of zero may move the other way
    (as in test_torch_dp_train's MoE comparison): such an element must
    be one (its first moment no larger than the moments' largest
    difference), and the limits hold on the others. ``ce`` is the last
    micro-batch's: with ``ce`` False (``grad_accum`` 2 against a data
    axis, whose micro-batch is the global batch) it is not compared."""
    np.testing.assert_allclose(got["loss_f"][0], want["loss_f"][0],
                               rtol=LOSS_RTOL, err_msg=what)
    if ce:
        np.testing.assert_allclose(got["ce"][0], want["ce"][0],
                                   rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["grad_norm"][0], want["grad_norm"][0],
                               rtol=NORM_RTOL, err_msg=what)
    np.testing.assert_allclose(got["loss_f"][1:], want["loss_f"][1:],
                               atol=LATER[0], rtol=0, err_msg=what)
    np.testing.assert_allclose(got["grad_norm"][1:], want["grad_norm"][1:],
                               rtol=LATER[1], err_msg=what)
    for p, w in want["state1"].items():
        g, wf = _float(got["state1"][p]), _float(w)
        if p.startswith("['opt']['m']"):
            assert np.linalg.norm(g - wf) <= MOMENT_REL * np.linalg.norm(
                wf), (what, p)
        elif p.startswith("['params']"):
            base = _float(start[p])
            upd, d = wf - base, g - base
            if not upd.any():
                assert np.array_equal(g, wf), (what, p)
                continue
            m = p.replace("['params']", "['opt']['m']", 1)
            gm, wm = _float(got["state1"][m]), _float(want["state1"][m])
            flip = np.sign(d) != np.sign(upd)
            if flip.any():
                assert np.abs(wm[flip]).max() <= np.abs(gm - wm).max(), \
                    (what, p)
            keep = ~flip
            assert np.linalg.norm((g - wf)[keep]) < 0.5 * np.linalg.norm(
                upd[keep]), (what, p)
            assert _cos(d[keep], upd[keep]) >= 0.9, (what, p)


def _seams(cfg, sp: bool, remat: bool, chunks: int, seq: str = "") -> int:
    """Model-axis seam collectives a step: a layer's two blocks each
    enter and leave once a forward and their backward runs the other
    halves; under R the recomputation runs the forward's again up to
    the last tensor the backward needs (torch's checkpoint stops there),
    so without the layer's last seam; a loss block sums its max and its
    partial sums (again in its recomputation) and runs its f once
    backward; under sp the final hidden states are gathered once. In
    sequence mode (``seq="split"``) the attention block's only seam is
    the gather of its output rows without sp (none with it: the rows
    stay the rank's), backward the gather of its input's cotangent;
    where the attention is replicated (``seq="whole"``) it has none."""
    fwd = 4 if sp else 2
    if seq:
        fwd = 2 if seq == "split" else 1
    per_layer = 2 * fwd + ((fwd - 1) if remat else 0)
    return cfg.n_layers * per_layer + 5 * chunks + (1 if sp else 0)


TP_CASES = [("tp2", "qwen/F+R", "qwen/oracle"),
            ("tp2", "qwen/F+R+sp", "qwen/oracle"),
            ("tp2", "llama/F", "llama/oracle"),
            ("tp4", "glm/F+R+sp", "glm/oracle"),
            ("mesh22", "qwen/F+R+Z2", "qwen/oracle"),
            ("mesh22", "qwen/F+R+Z3+sp", "qwen/oracle")]


@pytest.mark.parametrize("mesh,case,oracle", TP_CASES)
def test_tp_step_holds_to_the_one_device_step(request, mesh, case, oracle):
    """Each TP run (qwen tied and MHA with sp off and on, llama2 untied
    with the vocab-cut head, chatglm3's two KV heads at tp 4 replicated
    and read by ``kv_part``, the (2 x 2) mesh under Z2 and Z3) against
    the one-device step (``grad_accum`` = the data degree) at the
    module's limits, every rank holding the same whole state; every rank
    issues the same seam collectives, as many as the blocks, the
    recomputation and the loss blocks make."""
    ranks = request.getfixturevalue(mesh)
    want = ranks[0][oracle]
    cfg = get_config(ARCHS[case.split("/")[0]], reduced=True)
    seams = _seams(cfg, "sp" in case, "F+R" in case, chunks=1)
    for r, out in enumerate(ranks):
        got = out[case]
        what = f"{case} rank {r}"
        assert got["state"].keys() == want["state"].keys()
        for p in got["state"]:
            assert np.array_equal(got["state"][p],
                                  ranks[0][case]["state"][p]), (what, p)
        assert got["seams"] == [seams] * STEPS, (what, got["seams"])
    _holds(ranks[0][case], want, _seed_params(cfg), case,
           ce=mesh != "mesh22")


def _seed_params(cfg):
    """The seeded one-device params' bits, keyed as the runs' states."""
    params = LM(cfg, device="cpu").init(0)
    return {f"['params']{p}": worker.host(t)
            for p, t in keystr_paths(params)}


@pytest.mark.parametrize("case,emulated", [("qwen/F+R", "qwen/emulated"),
                                           ("qwen/F+R+sp",
                                            "qwen/emulated+sp"),
                                           ("llama/F", "llama/emulated")])
def test_tp_forward_is_the_one_device_forward_in_tp_order(tp2, case,
                                                         emulated):
    """Teacher forced (step 1's forward from the seed), TP = 2's loss on
    both ranks equals, bit for bit, the one-device forward computed in
    TP = 2's order of sums: the order of sums is the whole difference."""
    want = tp2[0][emulated]
    for r, out in enumerate(tp2):
        assert out[case]["loss"][0] == want, (case, r)


def test_mamba2_folds_the_model_axis_bitwise(tp2):
    """mamba2 has ``dp_over_model``: on a (1 x 2) mesh its context folds
    the model axis into the data axes, and F+R+Z3 there is the
    one-device ``grad_accum = 2`` step bit for bit, as at dp 2."""
    want = tp2[0]["mamba/oracle"]
    for r, out in enumerate(tp2):
        got = out["mamba/F+R+Z3"]
        assert got["loss"] == want["loss"], r
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)
        bad = [p for p in want["state"]
               if not np.array_equal(got["state"][p], want["state"][p])]
        assert not bad, (r, bad[:4])
        assert got["seams"] == [0] * STEPS


@pytest.mark.parametrize("mesh,case", [(m, c) for m, c, _ in TP_CASES])
def test_logits_blocks_hold_a_vocab_slice(request, mesh, case):
    """The loss never holds the vocabulary's logits under a model axis:
    every logits block a rank computes (each loss block, again in its
    recomputation) has V/tp columns of the padded vocabulary."""
    ranks = request.getfixturevalue(mesh)
    tp = {"tp2": 2, "tp4": 4, "mesh22": 2}[mesh]
    v = padded_vocab(get_config(ARCHS[case.split("/")[0]],
                                reduced=True).vocab_size)
    for out in ranks:
        assert out[case]["widths"] == [v // tp] * (2 * STEPS)


@pytest.mark.parametrize("case", ["qwen/F+R+Z2", "qwen/F+R+Z3+sp"])
def test_2d_pieces_are_the_placements_cut(mesh22, case):
    """On the (2 x 2) mesh every rank's own pieces of params, moments and
    master weights equal the cut the reference's placement
    (``state_shardings``: the model axis on the TP dim, the ZeRO overlay
    over the data axis on another) gives of the gathered whole."""
    for r, out in enumerate(mesh22):
        got = out[case]
        assert got["own"].keys() == got["cut"].keys()
        for p, bits in got["own"].items():
            assert bits.shape == got["cut"][p].shape, (r, p)
            assert np.array_equal(bits, got["cut"][p]), (r, p)


def test_rank0_matches_the_reference_step(tp2, reference):
    """From the reference's bridged state, rank 0's F+R step at tp 2 with
    sequence parallelism against the reference's one-device step on the
    same batch, at test_torch_dp_train's step-1 limits: the loss within
    LOSS_ATOL and grad_norm within 1%."""
    m = reference
    got = tp2[0]["bridged"]
    assert abs(got["loss_f"][0] - m["loss"]) < LOSS_ATOL
    assert got["grad_norm"][0] == pytest.approx(m["grad_norm"], rel=0.01)


def test_cli_model_parallel_runs_on_the_cpu(capsys):
    """``--model-parallel 2``: the rank mapping, then rank 0's lines and
    each rank's trainable count."""
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "32", "--technique", "F+R",
                    "--sp", "--model-parallel", "2", "--dist-backend",
                    "gloo"])
    out = capsys.readouterr().out
    assert "[mesh] 2 ranks (1 data x 2 model), backend gloo" in out
    assert "1 data-parallel ranks x 2 model-parallel" in out
    assert "rank 1: F+R:" in out
    assert "step      2  loss" in out and "tokens/s" in out


SEQ_CASES = [("tp2", "qwen/F+R+seq", "qwen/oracle"),
             ("tp2", "qwen/F+R+seq+sp", "qwen/oracle"),
             ("tp2", "glm/F+R+seq", "glm/oracle"),
             ("tp2", "glm/F+R+seq+sp", "glm/oracle"),
             ("tp4", "six/R+auto", "six/oracle"),
             ("tp4", "odd/F+R+seq", "odd/oracle"),
             ("mesh22", "qwen/F+R+Z3+seq+sp", "qwen/oracle")]


@pytest.mark.parametrize("mesh,case,oracle", SEQ_CASES)
def test_seq_step_holds_to_the_one_device_step(request, mesh, case, oracle):
    """Sequence (context-parallel) attention against the one-device step
    at the module's limits, every rank holding the same whole state:
    explicit at (1 x 2) with sp off and on (qwen, chatglm3's grouped
    KV), ``"auto"`` turning to it where 4 ranks do not divide six heads
    (the naive route), Z3 + sp on the (2 x 2) mesh, and a T of 30 at tp
    4, where the attention is replicated and its gradients are not
    summed (no k/v collective). Every rank issues the seams its blocks
    make and one k/v gather a forward (again in the recomputation) and
    one f32 sum of the k/v cotangents a backward, an attention layer."""
    ranks = request.getfixturevalue(mesh)
    want = ranks[0][oracle]
    cfg = get_config(ARCHS.get(case.split("/")[0], QWEN), reduced=True)
    if case.startswith("six"):
        cfg = dataclasses.replace(cfg, n_heads=SIX, n_kv_heads=SIX)
    split = not case.startswith("odd")
    remat = "R" in case.split("/")[1].split("+")
    seams = _seams(cfg, "sp" in case, remat, chunks=1,
                   seq="split" if split else "whole")
    kv = cfg.n_layers * (3 if remat else 2) if split else 0
    for r, out in enumerate(ranks):
        got = out[case]
        what = f"{case} rank {r}"
        assert got["mode"] == "seq", what
        for p in got["state"]:
            assert np.array_equal(got["state"][p],
                                  ranks[0][case]["state"][p]), (what, p)
        assert got["seams"] == [seams] * STEPS, (what, got["seams"])
        assert got["kv"] == [kv] * STEPS, (what, got["kv"])
    _holds(ranks[0][case], want, _seed_params(cfg), case,
           ce=mesh != "mesh22")


def test_seq_rank0_matches_the_reference_step(tp2, reference):
    """From the reference's bridged state, rank 0's F+R step at tp 2 in
    sequence mode against the reference's one-device step on the same
    batch: the loss within LOSS_ATOL and grad_norm within 1%."""
    m = reference
    got = tp2[0]["bridged/seq"]
    assert abs(got["loss_f"][0] - m["loss"]) < LOSS_ATOL
    assert got["grad_norm"][0] == pytest.approx(m["grad_norm"], rel=0.01)


def test_cli_attn_mode_seq_runs_on_the_cpu(capsys):
    """``--model-parallel 2 --attn-mode seq``: the ranks train in
    sequence mode, and rank 0's lines say so."""
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "32", "--technique", "F+R",
                    "--attn-mode", "seq", "--model-parallel", "2",
                    "--dist-backend", "gloo"])
    out = capsys.readouterr().out
    assert "2 model-parallel (attention in seq mode)" in out
    assert "rank 1: F+R:" in out
    assert "step      2  loss" in out and "tokens/s" in out


def test_pipeline_matches_sequential_and_reference(tp2, reference):
    """tests/test_substrate.py:143 on the port: the GPipe forward over 2
    stages of the model axis equals the port's sequential loop over the
    same layers bit for bit on both ranks, and the reference's
    ``pipeline_forward`` within 1e-5."""
    for r, out in enumerate(tp2):
        got = out["pipeline"]
        assert np.array_equal(got["out"], got["seq"]), r
        assert np.array_equal(got["out"], tp2[0]["pipeline"]["out"]), r
        assert got["bubble"] == pytest.approx(1 / 7)
    np.testing.assert_allclose(_float(tp2[0]["pipeline"]["out"]),
                               reference["pipeline"], atol=1e-5, rtol=1e-5)


def test_bubble_fraction():
    """tests/test_substrate.py:175 on the port."""
    from repro_torch.parallel.pipeline import bubble_fraction
    assert bubble_fraction(1, 4) == pytest.approx(3 / 4)
    assert bubble_fraction(32, 4) == pytest.approx(3 / 35)
