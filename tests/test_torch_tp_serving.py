"""Tensor-parallel serving of the port on the CPU: the engine sharded over
a model axis of gloo ranks (``launch.mesh.spawn_ranks``), the port's
counterparts of tests/test_sharded_serving.py:70-175 (which need 8
forced host devices of jax).

Each sharded run serves the reference's bridged smoke weights, and its
greedy tokens are held to the port's TP = 1 engine and to the
reference's single-device engine on the same weights and trace: the
reference's own contract. TP changes only the order in which f32
partials are summed at the row-parallel seams, so a stream could split
only at a bf16 near tie of the logits; the splits are counted and must
be 0 on these configs. The ranks start once per degree and serve every
scenario of that degree in turn (tests/torch_tp_worker.py, which imports
no JAX), one intra-op thread each.

The MoE archs (qwen3-moe and jamba smoke: 4 experts, top-2) run the
reference's expert parallelism (``_moe_ep``: each rank holds E/tp
experts, tokens exchanged with their ranks; a chunk of 4 split along t,
a decode step routed whole on every rank) and, with 6 experts at tp 4,
the dispatch with the experts cut on their MLP width; the reference's
own contract (tests/test_sharded_serving.py:93-105) holds them: tokens
equal to the single-device engine's, with no near-tie split either.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.data.pipeline import repetitive_requests
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import spawn_ranks

import torch_tp_worker as worker

NEAR_TIE_ULPS = 4
FULL_STACK = dict(kv_quant="int8", prefill_chunk=4, speculate="ngram",
                  spec_depth=4, max_batch=4, n_blocks=64, block_size=8)
MOE_STACK = dict(kv_quant="int8", prefill_chunk=4, max_batch=4,
                 block_size=8)
# name -> (arch, prompt lengths, new tokens, engine arguments[, the
# config's fields replaced])
SCENARIOS = {
    "full_stack": ("qwen1.5-0.5b", (12, 12, 10, 12), 8, FULL_STACK),
    "preemption": ("qwen1.5-0.5b", (8, 8, 8, 8), 6,
                   dict(n_blocks=6, block_size=4, max_batch=3,
                        prefill_chunk=4)),
    "ssm_whole": ("mamba2-130m", (12, 12, 10, 12), 8,
                  dict(kv_quant="int8", max_batch=4, block_size=8)),
    "ssm_chunk": ("mamba2-130m", (12, 12, 10, 12), 8,
                  dict(kv_quant="int8", prefill_chunk=4, max_batch=4,
                       block_size=8)),
    # granite smoke: 4 q heads over 2 KV heads, so at tp 4 the q heads
    # split and the KV heads do not
    "indivisible": ("granite-3-2b", (12, 12, 10, 12), 8,
                    dict(kv_quant="int8", prefill_chunk=4, max_batch=4,
                         block_size=8)),
    "moe_ep": ("qwen3-moe-30b-a3b", (12, 12, 10, 12), 8, MOE_STACK),
    # jamba smoke is ~10x qwen3-moe's cost a step: two streams
    "hybrid_ep": ("jamba-v0.1-52b", (12, 10), 4, MOE_STACK),
    # 6 experts at tp 4: the experts whole on every rank, cut on their
    # MLP width (the down projection a row-parallel seam)
    "moe_mlp": ("qwen3-moe-30b-a3b", (12, 12, 10, 12), 8, MOE_STACK,
                {"n_experts": 6}),
}
# streams of the port's TP = 1 engine that split from the reference's at
# a near tie: with 6 experts, three repetitive prompts reach one context
# whose top two logits (3.203125, 3.171875) are 2 bf16 ulps apart
ONE_DEVICE_SPLITS = {"moe_mlp": 3}
BY_DEGREE = {2: ("full_stack", "preemption", "ssm_whole", "ssm_chunk",
                 "moe_ep", "hybrid_ep"),
             4: ("full_stack", "indivisible", "moe_ep", "moe_mlp")}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread: the driver runs six test processes
    at once, and each one's default thread pool over every core slows
    all of them (the ranks take one thread each too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenario(name):
    """(arch, lens, max_new, engine arguments, config fields replaced)."""
    arch, lens, max_new, kw, *cfg_kw = SCENARIOS[name]
    return arch, lens, max_new, kw, (cfg_kw or [{}])[0]


@functools.lru_cache(maxsize=None)
def _weights(arch, cfg_items=()):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **dict(cfg_items))
    params = LM(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, from_jax_numpy(jax.device_get(params))


def _scenario_weights(name):
    arch, _, _, _, cfg_kw = _scenario(name)
    return _weights(arch, tuple(sorted(cfg_kw.items())))


def _prompts(cfg, lens):
    """Repeated-pattern prompts of ``lens``: the n-gram proposer fires on
    them, so the full-stack runs verify real proposals."""
    return [p[:n] for p, n in zip(
        repetitive_requests(len(lens), cfg.vocab_size, max(lens)), lens)]


def _run_args(name):
    arch, lens, max_new, kw, cfg_kw = _scenario(name)
    cfg, _, tparams = _scenario_weights(name)
    return arch, tparams, _prompts(cfg, lens), max_new, kw, cfg_kw


@functools.lru_cache(maxsize=None)
def _reference(name):
    _, lens, max_new, kw, _ = _scenario(name)
    cfg, params, _ = _scenario_weights(name)
    eng = JaxEngine(cfg, params, **kw)
    for rid, p in enumerate(_prompts(cfg, lens)):
        eng.submit(JaxRequest(rid=rid, tokens=list(p),
                              max_new_tokens=max_new))
    eng.run(max_steps=800)
    return ({r.rid: list(r.output) for r in eng.finished},
            eng.stats().get("spec_rounds"))


@functools.lru_cache(maxsize=None)
def _single(name):
    return worker.serve(None, *_run_args(name))


_POOL = ThreadPoolExecutor(1)
_SPAWNS = {}


def _start_spawns():
    """Queue every degree's ranks, one spawn after the other in a thread
    of this process (the weights drawn here first), so they serve while
    this process runs the reference's and the one-device engines."""
    for tp, names in BY_DEGREE.items():
        if tp not in _SPAWNS:
            args = [_run_args(n) for n in names]
            _SPAWNS[tp] = _POOL.submit(
                spawn_ranks, worker.serve_all, tp, backend="gloo",
                device="cpu", args=(args,), threads=1)


@functools.lru_cache(maxsize=None)
def _sharded(tp):
    """Every scenario of degree ``tp``, each rank's record, by name."""
    _start_spawns()
    ranks = _SPAWNS[tp].result()
    return {n: [recs[i] for recs in ranks]
            for i, n in enumerate(BY_DEGREE[tp])}


def _splits(want, got):
    """(rid, first differing position) of every stream that splits."""
    return [(rid, next(j for j, (a, b) in enumerate(zip(w, got[rid]))
                       if a != b) if len(w) == len(got[rid]) else -1)
            for rid, w in want.items() if got.get(rid) != w]


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


@functools.lru_cache(maxsize=None)
def _reference_row(name, rid, j):
    """The reference's logits after stream ``rid``'s prompt and its first
    ``j`` tokens (its dense forward, teacher forced)."""
    lens = _scenario(name)[1]
    cfg, params, _ = _scenario_weights(name)
    want, _ = _reference(name)
    seq = np.asarray([list(_prompts(cfg, lens)[rid]) + want[rid][:j]],
                     np.int32)
    return np.asarray(LM(cfg).forward(params, {"tokens": seq})[0, -1],
                      np.float32)


def _near_ties(name, got):
    """Hold a stream set against the reference's: where one splits, the
    port's token must be within ``NEAR_TIE_ULPS`` bf16 ulps of the top of
    the reference's own logits there (its dense forward, teacher-forced
    on its stream), the port's rule against the reference
    (tests/test_torch_engine.py). Returns the splits."""
    want, _ = _reference(name)
    splits = _splits(want, got)
    for rid, j in splits:
        row = _reference_row(name, rid, j)
        top = float(row.max())
        tok = got[rid][j]
        assert row[tok] >= top - NEAR_TIE_ULPS * _bf16_ulp(top), (
            f"{name} rid {rid} splits from the reference at token {j}: "
            f"{tok} (logit {row[tok]}) vs {want[rid][j]} (top {top})")
    return splits


def _hold(name, tp):
    """Each rank's tokens against the port's TP = 1 run (equal) and the
    reference's single-device run (equal up to the port's near-tie rule;
    the sharded run splits where TP = 1 does); returns the ranks'
    records."""
    _start_spawns()
    base = _single(name)
    ref_splits = _near_ties(name, base["out"])
    recs = _sharded(tp)[name]
    assert len(recs) == tp
    for rank, rec in enumerate(recs):
        assert rec["stats"]["model_parallel"] == tp
        assert _splits(base["out"], rec["out"]) == [], (name, tp, rank)
        assert _near_ties(name, rec["out"]) == ref_splits
    return base, recs


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_parity_full_stack_qwen(tp):
    """int8 KV + chunked prefill + n-gram speculation: the tokens, and so
    the verify rounds, equal TP = 1's and the reference's."""
    base, recs = _hold("full_stack", tp)
    _, ref_rounds = _reference("full_stack")
    assert base["stats"]["spec_rounds"] == ref_rounds > 0
    for rec in recs:
        assert rec["stats"]["spec_rounds"] == ref_rounds
        assert rec["stats"]["verify_steps"] == base["stats"]["verify_steps"]


@pytest.mark.parametrize("name", ["ssm_whole", "ssm_chunk"])
def test_tp_parity_ssm(name):
    """mamba2 at tp 2 (int8 KV on its dummy pool), both prefill
    schedules: each rank's SSM slot pool holds its heads (H/tp) and
    their conv channels (x of its heads, B and C whole)."""
    base, recs = _hold(name, 2)
    cfg = get_config("mamba2-130m", reduced=True)
    gn = 2 * cfg.ssm_ngroups * cfg.ssm_state
    for rec in recs:
        conv, state = rec["ssm"]["pos0/conv"], rec["ssm"]["pos0/state"]
        assert state.shape[2] == cfg.n_ssm_heads // 2
        assert conv.shape[-1] == cfg.d_inner // 2 + gn


def test_tp_parity_under_preemption():
    """An undersized pool forces evictions: the ranks make the
    single-device engine's decisions (as many preemptions, > 0), emit its
    tokens, and every block is free at the end."""
    base, recs = _hold("preemption", 2)
    assert base["preemptions"] > 0
    for rec in recs:
        assert rec["preemptions"] == base["preemptions"]
        n_free, n_blocks = rec["free"]
        assert n_free == n_blocks


def test_kv_pool_sharded_on_kv_heads():
    """qwen smoke's 4 KV heads at tp 4: every rank's k, v and int8 scales
    hold K/tp heads, bytes equal to the TP = 1 pool's slice of them."""
    base, recs = _hold("full_stack", 4)
    k = get_config("qwen1.5-0.5b", reduced=True).n_kv_heads
    assert k % 4 == 0
    for rank, rec in enumerate(recs):
        assert set(rec["pool"]) == {"k", "v", "k_scale", "v_scale"}
        w = k // 4
        for key, a in rec["pool"].items():
            assert a.shape[3] == w, (key, a.shape)
            np.testing.assert_array_equal(
                a, base["pool"][key][:, :, :, rank * w:(rank + 1) * w])


def test_tp_indivisible_heads():
    """granite smoke at tp 4 (H = 4, K = 2): the q heads split, the KV
    heads and the pool stay whole on every rank (each rank reads the KV
    head its q head maps to), and the tokens equal TP = 1's. Every rank
    writes the same pool. Layer 0's entries, computed before any
    row-parallel sum, are TP = 1's bit for bit; layer 1 reads a residual
    stream whose f32 partials were summed in another order, so an int8
    code may move by one (two of 32,768 do here) and a scale by a bf16
    ulp of its vector's amax."""
    base, recs = _hold("indivisible", 4)
    cfg = get_config("granite-3-2b", reduced=True)
    for rec in recs:
        shapes = rec["mix_shapes"]
        assert shapes["wq"][-2] == cfg.n_heads // 4
        assert shapes["wo"][1] == cfg.n_heads // 4
        assert shapes["wk"][-2] == cfg.n_kv_heads
        for key, a in rec["pool"].items():
            want = base["pool"][key]
            assert a.shape == want.shape and a.shape[3] == cfg.n_kv_heads
            np.testing.assert_array_equal(a, recs[0]["pool"][key])
            np.testing.assert_array_equal(a[0], want[0])
            if key.endswith("_scale"):
                np.testing.assert_allclose(a, want, rtol=2.0 ** -7, atol=0)
            else:
                assert np.abs(a.astype(int) - want).max() <= 1, key


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_trace_counts_match(tp):
    """TP adds no step kind and no step key: each run's trace_counts
    equal TP = 1's, one first use per key."""
    for name in BY_DEGREE[tp]:
        base = _single(name)
        for rec in _sharded(tp)[name]:
            assert rec["trace_counts"] == base["trace_counts"], name
        assert all(v == 1 for v in base["trace_counts"].values())


@pytest.mark.parametrize("name,tp", [("moe_ep", 2), ("hybrid_ep", 2),
                                     ("moe_ep", 4), ("moe_mlp", 4)])
def test_tp_parity_moe(name, tp):
    """The MoE archs under TP, chunked (4) with int8 KV: each rank's
    tokens equal TP = 1's and the reference's single-device engine's
    with no split at all (near tie or not; the 6-expert config's
    one-device engine splits from the reference at a 2-ulp near tie,
    ``ONE_DEVICE_SPLITS``, and TP's tokens are that engine's). Where the
    degree divides the
    experts each rank holds E/tp of them (expert parallelism); with 6
    experts at tp 4 every rank holds all 6, cut on their MLP width."""
    base, recs = _hold(name, tp)
    assert len(_near_ties(name, base["out"])) == ONE_DEVICE_SPLITS.get(
        name, 0)
    cfg, _, _ = _scenario_weights(name)
    e, f = cfg.n_experts, cfg.d_ff
    want = ((e // tp, cfg.d_model, f) if e % tp == 0 else
            (e, cfg.d_model, f // tp))
    for rec in recs:
        moe = [k for k, v in rec["ffn_shapes"].items()
               if k.endswith("/w_gate") and len(v) == 4]
        assert moe
        for key in moe:
            assert rec["ffn_shapes"][key][1:] == want, (key, want)


def test_serve_cli_model_parallel(capsys):
    """``--device cpu --model-parallel 2`` prints ``model_parallel: 2``
    and the TP = 1 run's tokens."""
    argv = ["--device", "cpu", "--requests", "4", "--max-new", "6",
            "--int8-kv", "--prefill-chunk", "8"]

    def run(extra):
        serve_cli.main(argv + extra)
        lines = capsys.readouterr().out.splitlines()
        stats = dict(line.strip().split(": ", 1) for line in lines
                     if ": " in line and not line.startswith("[mesh]"))
        toks = [line.strip() for line in lines
                if line.strip().startswith("tokens:")]
        return stats, toks

    one, toks_one = run([])
    two, toks_two = run(["--model-parallel", "2"])
    assert one["model_parallel"] == "1" and two["model_parallel"] == "2"
    assert len(toks_one) == 4 and toks_two == toks_one


def test_failed_rank_fails_the_run():
    """A rank that raises fails the launch, naming the rank and its
    error; the ranks still running are terminated."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(?s:.*)planted failure on rank 1"):
        spawn_ranks(worker.fail_on, 2, backend="gloo", device="cpu",
                    args=(1,), threads=1)
