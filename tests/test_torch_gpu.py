"""The port's CUDA kernel on the card: against its plain version, the
bitwise T=1 == decode contract, and the launch count of an engine run.

These tests import neither ``jax`` nor the JAX package, so they also run
on the GPU host: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``. Without a card they skip."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import serving_requests
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.lm import LM
from repro_torch.serving.cache import quant_encode
from repro_torch.serving.engine import Engine, Request

TOL = dict(rtol=2e-5, atol=2e-5)     # the repo's f32 kernel tolerance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, t, h, kv, d, quant, seed=0):
    """Rows: full (5 live pages), short (2 pages of a 6-wide bucket) and
    zero-length; block_size 16 as the engine uses."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, bs, mb, n_blocks = 3, 16, 6, 24
    q = torch.randn((b, t, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((n_blocks, bs, kv, d), generator=g, device=dev)
    v = torch.randn((n_blocks, bs, kv, d), generator=g, device=dev)
    k, v = k.bfloat16(), v.bfloat16()
    ks = vs = None
    if quant:
        k, ks = quant_encode(k, "int8")
        v, vs = quant_encode(v, "int8")
    table = torch.tensor([[5, 2, 9, 1, 7, 11], [3, 8, 0, 0, 0, 0],
                          [0, 0, 0, 0, 0, 0]], dtype=torch.int32, device=dev)
    lengths = torch.tensor([5 * bs - 3, bs + 2, 0], dtype=torch.int32,
                           device=dev)
    return q, k, v, table, lengths, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 64), (16, 16, 64), (4, 1, 128)])
@pytest.mark.parametrize("quant", [False, True])
def test_kernel_matches_plain(cuda, t, h, kv, d, quant):
    args = _case(cuda, t, h, kv, d, quant)
    want = fd._paged_prefix_torch(*args)
    before = fd.LAUNCHES["paged_attention"]
    got = fd.paged_flash_prefix_partial(*args[:5], k_scale=args[5],
                                        v_scale=args[6])
    torch.cuda.synchronize()
    assert fd.LAUNCHES["paged_attention"] == before + 1
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, **TOL)
    o, m, l = got
    assert torch.all(o[2] == 0) and torch.all(l[2] == 0)
    assert torch.all(m[2] == -1e30)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_t1_prefix_read_is_decode_read_bitwise(cuda, quant):
    q, k, v, table, lengths, ks, vs = _case(cuda, 1, 4, 2, 64, quant)
    one = fd.paged_flash_decode_partial(q[:, 0], k, v, table, lengths,
                                        k_scale=ks, v_scale=vs)
    mq = fd.paged_flash_prefix_partial(q, k, v, table, lengths,
                                       k_scale=ks, v_scale=vs)
    for a, b in zip(one, mq):
        assert torch.equal(a, b[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_engine_reads_through_the_kernel(cuda, prefill_chunk):
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = LM(cfg, device=cuda).init(0)
    eng = Engine(cfg, params, max_batch=4, n_blocks=64, block_size=4,
                 kv_quant="int8", prefill_chunk=prefill_chunk, device=cuda)
    for i, p in enumerate(serving_requests(6, cfg.vocab_size,
                                           prompt_lens=[5, 12, 9])):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=6))
    fd.LAUNCHES.clear()
    done = eng.run()
    st = eng.stats()
    assert len(done) == 6 and all(len(r.output) == 6 for r in done)
    assert fd.LAUNCHES["paged_attention"] == cfg.n_layers * (
        st["decode_steps"] + st["chunk_steps"])
