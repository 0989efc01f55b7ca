"""The port's serving engine against the JAX package's ``Engine(mode=
"fused")`` on the same bridged qwen1.5-0.5b smoke weights and the same
trace, over kv_quant {none, int8} x prefill {whole, chunk 8} x max_batch
{1, 4}, plus a pool small enough to force preemptions; and on the
llama2 family's smoke configs (no QKV bias, an untied head; 70b with
grouped KV heads) whole-prompt bf16 and chunked int8 at max_batch 4,
with their prefill and forward logits.

Greedy streams must be equal. The one allowed exception is a bf16 near
tie: the two frameworks sum f32 products in different orders, so a
logit can round one bf16 ulp apart, and where the reference's two best
logits sit within a few ulps the argmax may go either way. A stream may
therefore split only at a position where the reference's own logits
(its dense forward, teacher-forced on its stream) put the port's token
within ``NEAR_TIE_ULPS`` bf16 ulps of the top logit; everything before
the split must match token for token.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import serving_requests
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models.lm import LM as PortLM
from repro_torch.serving.engine import Engine, Request

NEAR_TIE_ULPS = 4
TRACE = dict(n=6, lens=[5, 12, 9], max_new=6)
PRESSURE = dict(n=5, lens=[24, 40, 32], max_new=8)
LLAMA2 = ["llama2-7b", "llama2-13b", "llama2-70b"]
# the other dense configs: grouped KV heads (granite G = 4, qwen2.5 G = 5
# with QKV bias, theta 1e6 and eps 1e-6, chatglm3 G = 16 with RoPE on half
# the head dim), granite with a tied head
DENSE = ["granite-3-2b", "qwen2.5-14b", "chatglm3-6b"]
# qwen over the whole grid (the ids the grid has always had), each llama2
# config whole-prompt bf16 and chunked int8, one case of each other dense
# config
ENGINE_CASES = [
    pytest.param("qwen1.5-0.5b", quant, chunk, batch,
                 id=f"{quant}-{chunk}-{batch}")
    for quant in ("none", "int8") for chunk in (None, 8)
    for batch in (1, 4)] + [
    pytest.param(arch, quant, chunk, 4, id=f"{arch}-{quant}-{chunk}-4")
    for arch in LLAMA2 for quant, chunk in (("none", None), ("int8", 8))] + [
    pytest.param(arch, quant, chunk, 4, id=f"{arch}-{quant}-{chunk}-4")
    for arch, quant, chunk in (("granite-3-2b", "none", None),
                               ("qwen2.5-14b", "int8", 8),
                               ("chatglm3-6b", "int8", 8))]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = get_config(arch, reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


@pytest.fixture(scope="module")
def weights():
    return _weights("qwen1.5-0.5b")


def _serve(engine_cls, request_cls, cfg, params, trace, **kw):
    eng = engine_cls(cfg, params, **kw)
    prompts = serving_requests(trace["n"], cfg.vocab_size,
                               prompt_lens=trace["lens"])
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, tokens=p,
                               max_new_tokens=trace["max_new"]))
    done = eng.run(max_steps=2000)
    assert len(done) == trace["n"]
    assert all(len(r.output) == trace["max_new"] for r in done)
    return prompts, {r.rid: r.output for r in done}, eng.sched.n_preemptions


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _assert_streams_agree(model, params, prompts, want, got):
    splits = []
    for rid, ref in want.items():
        out = got[rid]
        j = next((i for i, (a, b) in enumerate(zip(ref, out)) if a != b),
                 None)
        if j is None:
            continue
        seq = jnp.asarray([prompts[rid] + ref[:j]], jnp.int32)
        row = np.asarray(model.forward(params, {"tokens": seq})[0, -1],
                         np.float32)
        top = float(row.max())
        margin = NEAR_TIE_ULPS * _bf16_ulp(top)
        assert row[out[j]] >= top - margin, (
            f"rid {rid} splits at token {j}: port {out[j]} "
            f"(logit {row[out[j]]}) vs reference {ref[j]} (top {top}), "
            f"not a bf16 near tie (margin {margin})")
        splits.append((rid, j))
    return splits


@pytest.mark.parametrize("arch,kv_quant,prefill_chunk,max_batch",
                         ENGINE_CASES)
def test_greedy_tokens_match_reference(arch, kv_quant, prefill_chunk,
                                       max_batch):
    cfg, model, params, tparams = _weights(arch)
    kw = dict(max_batch=max_batch, n_blocks=64, block_size=4,
              kv_quant=kv_quant, prefill_chunk=prefill_chunk)
    prompts, want, _ = _serve(JaxEngine, JaxRequest, cfg, params, TRACE,
                              **kw)
    _, got, _ = _serve(Engine, Request, port_config(arch, reduced=True),
                       tparams, TRACE, device="cpu", **kw)
    _assert_streams_agree(model, params, prompts, want, got)


def test_pressure_pool_preempts_like_reference(weights):
    """n_blocks=12 x block_size=8 cannot hold the trace at once: both
    engines preempt, equally often, and still agree on the tokens."""
    cfg, model, params, tparams = weights
    kw = dict(max_batch=4, n_blocks=12, block_size=8, kv_quant="none",
              prefill_chunk=8)
    prompts, want, pre_j = _serve(JaxEngine, JaxRequest, cfg, params,
                                  PRESSURE, **kw)
    _, got, pre_t = _serve(Engine, Request,
                           port_config("qwen1.5-0.5b", reduced=True),
                           tparams, PRESSURE, device="cpu", **kw)
    assert pre_j > 0 and pre_t == pre_j
    _assert_streams_agree(model, params, prompts, want, got)


def test_prefill_logits_match_reference(weights):
    _check_prefill(weights, "qwen1.5-0.5b", 512)      # padded vocab


@pytest.mark.parametrize("arch", LLAMA2 + DENSE)
def test_llama2_forward_and_prefill_match_reference(arch):
    """Smoke llama2 (and the other dense configs: grouped KV heads, QKV
    bias, partial RoPE, a tied head): the logits, whole-sequence and after
    prefill, and the prefill cache, against the reference's. The whole
    sequence's logits agree to ``NEAR_TIE_ULPS`` bf16 ulps of each row's
    largest logit: the frameworks round their f32 sums to bf16 at the
    same points but sum in other orders, so most logits differ by an ulp
    or two of that scale (read on the CPU over three seeds: at most 2.6,
    qwen's smoke logits 2.8)."""
    cfg, model, params, tparams = _weights(arch)
    _check_prefill(_weights(arch), arch, 512)          # 256 padded
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 11)).astype(np.int32)
    lj = np.asarray(model.forward(params, {"tokens": jnp.asarray(toks)}),
                    np.float32)
    lt = PortLM(port_config(arch, reduced=True), device="cpu").forward(
        tparams, torch.tensor(toks)).float().numpy()
    assert lt.shape == lj.shape == (2, 11, 512)
    top = np.abs(lj).max(axis=-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.all(np.abs(lt - lj) <= NEAR_TIE_ULPS * ulp)


def _check_prefill(weights, arch, vocab):
    cfg, model, params, tparams = weights
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 13)).astype(np.int32)
    lj, cache_j, len_j = model.prefill(params, {"tokens": jnp.asarray(toks)})
    port = PortLM(port_config(arch, reduced=True), device="cpu")
    lt, cache_t, len_t = port.prefill(tparams, torch.tensor(toks))
    assert tuple(lt.shape) == lj.shape == (2, vocab)
    np.testing.assert_allclose(lt.float().numpy(),
                               np.asarray(lj, np.float32),
                               rtol=3e-2, atol=3e-2)
    assert tuple(cache_t["pos0"]["k"].shape) == cache_j["pos0"]["k"].shape
    np.testing.assert_allclose(cache_t["pos0"]["k"].float().numpy(),
                               np.asarray(cache_j["pos0"]["k"], np.float32),
                               rtol=3e-2, atol=3e-2)
    assert len_t.tolist() == np.asarray(len_j).tolist()


def test_step_counts(weights):
    """The step counts chip_smoke holds the kernel's launch counter to
    (one paged read per attention layer per decode or chunk step)."""
    _, _, _, tparams = weights
    cfg = port_config("qwen1.5-0.5b", reduced=True)
    eng = Engine(cfg, tparams, max_batch=4, n_blocks=64, block_size=4,
                 prefill_chunk=8, device="cpu")
    for i, p in enumerate(serving_requests(3, cfg.vocab_size,
                                           prompt_lens=[5, 12])):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=3))
    eng.run()
    st = eng.stats()
    assert st["chunk_steps"] == 1 + 2 + 1       # ceil(len / 8) per prompt
    assert st["decode_steps"] > 0 and st["finished"] == 3


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main, parse_mixed_lens
    main(["--device", "cpu", "--requests", "3", "--max-new", "3",
          "--mixed-lens", "5,11", "--prefill-chunk", "4", "--int8-kv"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "finished: 3" in out
    # warmup built the decode and chunk steps at table buckets 1 (the
    # 5-token prompt's one block of 8) and 2 (the 11 + 3 token footprint)
    assert "fused_step_traces: 4" in out
    assert parse_mixed_lens("16, 8") == [16, 8]
    for bad in ("16,,8", "x", "0"):
        with pytest.raises(ValueError):
            parse_mixed_lens(bad)


@pytest.mark.parametrize("arch,kv_quant", [
    ("qwen1.5-0.5b", "none"),
    ("qwen1.5-0.5b", "int8"),
    ("mamba2-130m", "none"),
])
def test_legacy_matches_fused_tokens(arch, kv_quant):
    """tests/test_serving.py:135 on the port: the legacy per-layer oracle
    (each layer's token paged, the pages gathered dense, naive f32
    attention) emits the fused steps' greedy tokens, bit for bit, with
    int8 KV and a partly occupied batch (5 requests on 3 slots)."""
    cfg = port_config(arch, reduced=True)
    params = PortLM(cfg, device="cpu").init(0)
    outs = {}
    for mode in ("legacy", "fused"):
        eng = Engine(cfg, params, max_batch=3, n_blocks=32, block_size=8,
                     kv_quant=kv_quant, mode=mode, ssd_impl="ref",
                     device="cpu")
        rng = np.random.default_rng(0)
        for rid in range(5):
            eng.submit(Request(
                rid=rid,
                tokens=rng.integers(1, cfg.vocab_size, size=12).tolist(),
                max_new_tokens=5))
        done = eng.run(max_steps=200)
        assert len(done) == 5 and eng.stats()["decode_steps"] > 0
        outs[mode] = {r.rid: r.output for r in done}
        assert eng.snapshot()["engine"]["mode"] == mode
        if mode == "legacy":
            assert not eng.trace_counts          # nothing built for it
    assert outs["fused"] == outs["legacy"]


def test_serve_cli_lifecycle_flags(capsys, tmp_path):
    """The prefix cache, a seeded fault schedule and the Chrome trace
    from the CLI, and its refusals (the reference CLI's ``ap.error``
    rules)."""
    import json
    from repro_torch.launch.serve import main
    out_path = tmp_path / "t.json"
    main(["--device", "cpu", "--prefix-cache", "--prefill-chunk", "8",
          "--chaos", "0", "--trace-out", str(out_path), "--requests", "4",
          "--max-new", "3", "--queue-cap", "8", "--deadline-s", "600"])
    out = capsys.readouterr().out
    for key in ("prefix_cache_hit_rate", "cached_tokens_reused",
                "timed_out", "cancelled", "rejected_reasons", "chaos",
                "trace_out"):
        assert f"{key}:" in out, key
    assert "finished: 4" in out
    trace = json.loads(out_path.read_text())
    assert trace["otherData"]["chaos_seed"] == 0
    assert any(e["name"] == "terminal" for e in trace["traceEvents"])
    main(["--device", "cpu", "--legacy", "--requests", "2", "--max-new",
          "2"])
    assert "mode: legacy" in capsys.readouterr().out
    for bad in (["--prefix-cache"], ["--trace-fenced"],
                ["--chaos", "1", "--legacy"], ["--fused", "--legacy"]):
        with pytest.raises(SystemExit):
            main(["--device", "cpu"] + bad)
