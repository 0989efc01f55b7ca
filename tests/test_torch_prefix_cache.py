"""The port's cross-request prefix cache against the JAX package's.

  * the radix trie and the ref-counted allocator: the same seeded
    sequence of admissions (match, share, alloc, register) and releases
    on both packages' ``PrefixCache`` / ``BlockAllocator`` gives equal
    matches, refcounts, free lists, parked sets, reclaim order and scrub
    calls;
  * the storage primitives the cache uses: ``copy_block`` and
    ``scrub_blocks`` round trip, ``gather`` on padded table ids (zeros)
    and ``write_token``, against the reference's bytes;
  * cache-on engines for qwen1.5-0.5b (bf16 and int8 KV) and mamba2-130m
    against the reference's cache-on engine on the same drip-fed
    shared-prefix trace: tokens under the near-tie rule of
    tests/test_torch_engine.py, the prefix counters and prefill tokens
    equal;
  * cache-on == cache-off on the port itself, bitwise: under preemption,
    through ``cancel`` and with n-gram speculation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import shared_prefix_requests as jax_shared_prefix
from repro.models.lm import LM
from repro.serving import cache as RC
from repro.serving import prefix_cache as RP
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.data.pipeline import shared_prefix_requests
from repro_torch.serving import cache as TC
from repro_torch.serving import prefix_cache as TP
from repro_torch.serving.engine import Engine, Request

from test_torch_engine import _assert_streams_agree

QWEN = "qwen1.5-0.5b"
MAMBA2 = "mamba2-130m"
PREFIX_COUNTERS = ("prefix_lookups", "prefix_hits", "prefix_tokens_reused",
                   "prefix_cow_copies", "prefill_tokens")


# ---------------------------------------------------------------------------
# Trie and allocator: one op sequence, both packages
# ---------------------------------------------------------------------------


def _trie_trace(prefix_mod, cache_mod, seed, n_ops=60):
    """Admit and release seeded requests (shared heads, random tails)
    over a 12-block pool with a prefix cache attached; record every
    observable after each op."""
    rng = np.random.default_rng(seed)
    bs = 4
    pc = prefix_mod.PrefixCache(bs)
    alloc = cache_mod.BlockAllocator(12)
    alloc.attach_cache(pc)
    scrubbed = []
    pc.scrub = scrubbed.extend
    heads = [rng.integers(1, 9, size=8).tolist() for _ in range(3)]
    live, trace = [], []
    for _ in range(n_ops):
        if live and (rng.random() < 0.4 or alloc.n_available < 4):
            blocks = live.pop(int(rng.integers(0, len(live))))
            alloc.release(blocks)
            trace.append(("release", blocks))
        else:
            toks = (heads[int(rng.integers(0, 3))]
                    + rng.integers(1, 9, size=int(rng.integers(1, 9)))
                    .tolist())
            node, cached = pc.match(toks)
            need = -(-len(toks) // bs) - len(cached)
            if cached:
                alloc.share(cached)
            try:
                fresh = alloc.alloc(need)
            except cache_mod.OutOfBlocks:
                if cached:
                    alloc.release(cached)
                trace.append(("oob", cached))
                continue
            blocks = cached + fresh
            for j in range(len(cached), len(toks) // bs):
                node = pc.register(node, tuple(toks[j * bs:(j + 1) * bs]),
                                   blocks[j])
            live.append(blocks)
            trace.append(("admit", cached, fresh))
        trace.append((sorted(alloc.free), list(alloc.refcount),
                      sorted(pc.unref.items()), pc.n_cached_blocks,
                      pc.n_evicted, list(scrubbed), alloc.occupancy()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trie_and_allocator_match_reference(seed):
    want = _trie_trace(RP, RC, seed)
    got = _trie_trace(TP, TC, seed)
    assert got == want
    assert any(op[0] == "admit" and op[1] for op in want[::2])  # hits
    assert want[-1][4] > 0                                     # reclaims


def test_snapshot_match_backtracks_like_reference():
    """With ``track_ssm`` a match backtracks to the deepest node carrying
    a snapshot, and ``align_blocks`` caps it to chunk boundaries."""
    out = []
    for mod in (RP, TP):
        pc = mod.PrefixCache(2, track_ssm=True)
        node, toks = None, list(range(1, 13))
        for d in range(6):
            node = pc.register(node, tuple(toks[2 * d:2 * d + 2]), d,
                               ssm=("snap", d) if d in (1, 4) else None)
        got = [pc.match(toks + [99])[1]]
        pc.align_blocks = 2
        got.append(pc.match(toks + [99])[1])
        out.append(got)
    assert out[0] == out[1] == [[0, 1, 2, 3, 4], [0, 1]]


# ---------------------------------------------------------------------------
# Storage primitives against the reference's bytes
# ---------------------------------------------------------------------------


def _kv_pair(quant, n_layers=2, n_blocks=6, seed=0):
    cfg = RC.PagedKVConfig(n_layers=n_layers, n_kv_heads=2, head_dim=8,
                           n_blocks=n_blocks, block_size=4, kv_quant=quant)
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_layers, 8, 2, 8)).astype(np.float32)
    v = rng.standard_normal((n_layers, 8, 2, 8)).astype(np.float32)
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    ref = RC.write_prefill(RC.init_state(cfg), quant, (kj, vj), [3, 1])
    port = TC.init_state(TC.PagedKVConfig(**cfg.__dict__))
    TC.write_prefill(port, quant, (from_jax_numpy(np.asarray(kj)),
                                   from_jax_numpy(np.asarray(vj))), [3, 1])
    return cfg, ref, port


def _assert_pool_equal(port, ref, n_blocks):
    for key in ref:
        np.testing.assert_array_equal(
            port[key][:, :n_blocks].float().numpy(),
            np.asarray(ref[key], np.float32), err_msg=key)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_copy_and_scrub_blocks_match_reference(quant):
    cfg, ref, port = _kv_pair(quant)
    fresh = TC.init_state(TC.PagedKVConfig(**cfg.__dict__))
    ref = RC.copy_block(ref, 3, 5)
    TC.copy_block(port, 3, 5)
    _assert_pool_equal(port, ref, cfg.n_blocks)
    ptrs = {k: v.data_ptr() for k, v in port.items()}
    ref = RC.scrub_blocks(ref, [1, 3, 5])
    TC.scrub_blocks(port, [1, 3, 5])
    _assert_pool_equal(port, ref, cfg.n_blocks)
    assert {k: v.data_ptr() for k, v in port.items()} == ptrs   # in place
    for key in port:                      # the never-written state again
        assert torch.equal(port[key], fresh[key])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_gather_on_padded_ids_matches_reference(quant):
    """Padded table ids (the pool's size, i.e. the port's null block, and
    -1) read as exact zeros; the live region equals the reference's."""
    cfg, ref, port = _kv_pair(quant)
    table = np.asarray([[3, 1, cfg.n_blocks, -1], [1, 3, 0, 0]], np.int32)
    for dtype in (jnp.bfloat16, jnp.float32):
        kj, vj = RC.gather(ref, 1, jnp.asarray(table), dtype)
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        kt, vt = TC.gather(port, 1, torch.from_numpy(table), tdt)
        for a, b in ((kt, kj), (vt, vj)):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        assert not kt[0, 8:].any()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_write_token_matches_reference(quant):
    """The all-layer append: a live row and a row routed past the pool
    (dropped by the reference, the null block's in the port)."""
    cfg, ref, port = _kv_pair(quant)
    rng = np.random.default_rng(5)
    k = jnp.asarray(rng.standard_normal((2, 2, 2, 8)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, 2, 2, 8)), jnp.bfloat16)
    blk, off = np.asarray([4, cfg.n_blocks], np.int32), np.asarray([2, 0],
                                                                   np.int32)
    ref = RC.write_token(ref, quant, (k, v), jnp.asarray(blk),
                         jnp.asarray(off))
    TC.write_token(port, quant, (from_jax_numpy(np.asarray(k)),
                                 from_jax_numpy(np.asarray(v))),
                   torch.from_numpy(blk), torch.from_numpy(off))
    _assert_pool_equal(port, ref, cfg.n_blocks)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_hbm_bytes_matches_reference(quant):
    """The pool proper's bytes (the port's null block aside)."""
    cfg = RC.PagedKVConfig(n_layers=3, n_kv_heads=2, head_dim=16,
                           n_blocks=10, block_size=4, kv_quant=quant)
    want = RC.PagedKVCache(cfg).hbm_bytes()
    assert TC.PagedKVCache(TC.PagedKVConfig(**cfg.__dict__)).hbm_bytes() \
        == want == 2 * 3 * 10 * 4 * 2 * (16 * (1 if quant == "int8" else 2)
                                         + (4 if quant == "int8" else 0))


def test_trace_generators_match_reference():
    """``shared_prefix_requests`` and ``poisson_arrivals`` draw what the
    reference draws for one seed."""
    from repro.data.pipeline import poisson_arrivals as jax_poisson
    from repro_torch.data.pipeline import poisson_arrivals
    for seed in (0, 3):
        assert shared_prefix_requests(5, 1000, prefix_len=40, suffix_len=6,
                                      seed=seed) == jax_shared_prefix(
            5, 1000, prefix_len=40, suffix_len=6, seed=seed)
        np.testing.assert_array_equal(poisson_arrivals(7, 2.5, seed=seed),
                                      jax_poisson(7, 2.5, seed=seed))


# ---------------------------------------------------------------------------
# Engines: the port's cache-on engine against the reference's
# ---------------------------------------------------------------------------

# (arch, kv_quant, prefill_chunk, prefix_len): the reference's cases
# (tests/test_prefix_cache.py:330-335) for qwen and mamba2
ENGINE_CASES = {"qwen-bf16": (QWEN, "none", 8, 24),
                "qwen-int8": (QWEN, "int8", 16, 24),
                "mamba2": (MAMBA2, "none", 32, 64)}


def _weights(arch):
    cfg = get_config(arch, reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


@pytest.fixture(scope="module")
def weights():
    return {arch: _weights(arch) for arch in (QWEN, MAMBA2)}


def _drip(eng, request_cls, prompts, max_new=5, max_steps=600):
    """Submit one request a step, so earlier prefixes register before
    later requests are admitted (tests/test_prefix_cache.py's pattern)."""
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, tokens=list(p),
                               max_new_tokens=max_new))
        eng.step()
    done = eng.run(max_steps=max_steps)
    assert len(done) == len(prompts)
    return {r.rid: list(r.output) for r in done}


def _assert_no_leaks(eng):
    assert eng.alloc.n_available == eng.alloc.n_blocks
    free = list(eng.alloc.free)
    assert len(free) == len(set(free))
    assert all(rc == 0 for rc in eng.alloc.refcount)


@pytest.fixture(scope="module")
def reference_runs(weights):
    out = {}
    for name, (arch, quant, chunk, plen) in ENGINE_CASES.items():
        cfg, _, params, _ = weights[arch]
        prompts = jax_shared_prefix(4, cfg.vocab_size, prefix_len=plen,
                                    suffix_len=8, seed=3)
        eng = JaxEngine(cfg, params, max_batch=2, n_blocks=64, block_size=8,
                        kv_quant=quant, prefill_chunk=chunk,
                        prefix_cache=True)
        toks = _drip(eng, JaxRequest, prompts)
        out[name] = (prompts, toks, {k: getattr(eng, k)
                                     for k in PREFIX_COUNTERS})
    return out


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_cache_on_engine_matches_reference(weights, reference_runs, case):
    arch, quant, chunk, plen = ENGINE_CASES[case]
    cfg, model, params, tparams = weights[arch]
    prompts, want, counters = reference_runs[case]
    assert shared_prefix_requests(4, cfg.vocab_size, prefix_len=plen,
                                  suffix_len=8, seed=3) == prompts
    eng = Engine(port_config(arch, reduced=True), tparams, max_batch=2,
                 n_blocks=64, block_size=8, kv_quant=quant,
                 prefill_chunk=chunk, prefix_cache=True, ssd_impl="ref",
                 device="cpu")
    got = _drip(eng, Request, prompts)
    _assert_streams_agree(model, params, prompts, want, got)
    assert {k: getattr(eng, k) for k in PREFIX_COUNTERS} == counters
    assert counters["prefix_hits"] > 0 and counters["prefix_cow_copies"] == 0
    _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# Cache-on == cache-off on the port itself, bitwise
# ---------------------------------------------------------------------------


def _port_run(tparams, prompts, *, prefix_cache, max_new=8, arch=QWEN,
              cancel=None, **kw):
    eng = Engine(port_config(arch, reduced=True), tparams,
                 prefix_cache=prefix_cache, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=max_new))
        eng.step()
    if cancel is not None:
        assert eng.cancel(cancel) is True
    done = eng.run(max_steps=1500)
    assert len(done) == len(prompts)
    return eng, {r.rid: (r.state, list(r.output)) for r in done}


@pytest.mark.parametrize("mode", ["preemption", "cancel", "ngram"])
def test_cache_on_equals_cache_off(weights, mode):
    """Per-request greedy output is schedule-independent, so the cache
    must not change a token: an undersized pool (both runs preempt), a
    request cancelled mid-flight, and n-gram speculation."""
    tparams = weights[QWEN][3]
    vocab = weights[QWEN][0].vocab_size
    kw = dict(max_batch=2, n_blocks=64, block_size=8, prefill_chunk=8)
    cancel = None
    if mode == "preemption":
        kw.update(max_batch=4, n_blocks=10)     # both runs preempt
    elif mode == "cancel":
        cancel = 2
    else:
        kw.update(speculate="ngram", spec_depth=3)
    prompts = shared_prefix_requests(4, vocab, prefix_len=24, suffix_len=8,
                                     seed=7)
    off_eng, off = _port_run(tparams, prompts, prefix_cache=False,
                             cancel=cancel, **kw)
    on_eng, on = _port_run(tparams, prompts, prefix_cache=True,
                           cancel=cancel, **kw)
    assert on == off
    st = on_eng.stats()
    assert st["prefix_cache_hit_rate"] > 0.0
    assert st["prefill_tokens"] < off_eng.stats()["prefill_tokens"]
    if mode == "preemption":
        assert on_eng.sched.n_preemptions > 0
        assert off_eng.sched.n_preemptions > 0
    if mode == "cancel":
        assert on[2][0] == "cancelled"
    if mode == "ngram":
        assert st["spec_rounds"] > 0
    _assert_no_leaks(on_eng)
    assert off_eng.alloc.n_free == off_eng.alloc.n_blocks


def test_mamba2_snapshot_is_a_copy_of_the_slot(weights):
    """A trie node's SSM snapshot is the slot's state when it was taken,
    not a view that follows the slot as it decodes; a hit restores it,
    and cache-on tokens equal cache-off's."""
    tparams = weights[MAMBA2][3]
    vocab = weights[MAMBA2][0].vocab_size
    prompts = shared_prefix_requests(3, vocab, prefix_len=64, suffix_len=8,
                                     seed=4)
    kw = dict(arch=MAMBA2, max_batch=2, n_blocks=64, block_size=8,
              prefill_chunk=32, ssd_impl="ref")
    _, off = _port_run(tparams, prompts, prefix_cache=False, **kw)
    eng, on = _port_run(tparams, prompts, prefix_cache=True, **kw)
    assert on == off
    snaps = [n.ssm for n in eng._prefix.by_block.values()
             if n.ssm is not None]
    assert snaps
    pool = [a for st in eng._ssm_states.values() for a in st.values()]
    for snap in snaps:
        for leaves in snap.values():
            for a in leaves.values():
                assert all(a.untyped_storage().data_ptr()
                           != p.untyped_storage().data_ptr() for p in pool)
    assert eng.prefix_hits == 2
