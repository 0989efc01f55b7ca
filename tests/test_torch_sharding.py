"""The port's model-axis sharding (``repro_torch.parallel.sharding``)
against the reference's ``repro.parallel.sharding``, with no processes.

The reference's resolver answers on a one-device CPU when its
``ShardCtx`` holds a stand-in mesh (``shape`` and ``axis_names``); its
``NamedSharding`` is patched to hand back the bare spec. For every leaf
of all 13 configs, smoke and full width, at tp 2, 4 and 8, the port
splits the dim the reference splits; the paged pool and the SSM slot
pool it allocates are cut on the axis of the reference's specs.
``shard_params`` over all ranks reassembles the full tree bit for bit,
the expert leaves of an MoE arch are cut on the experts axis, or on
their MLP width where the degree does not divide the experts, and the
model-parallel engine refuses what it does not serve: the legacy mode, nccl ranks sharing a card, CUDA-graph capture
of steps that hold collectives, deadlines. The RMSNorm of a row
split over ranks (the gated norm's partial sums added over the parts)
equals the reference's norm of the whole row, and the paged read's CUDA
wrapper takes a window of a pool's KV heads in place.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.parallel.sharding as ref_sharding
from repro.kernels import ops as rops
import repro.serving.engine as ref_engine
from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.models import blocks as RB
from repro.models.lm import LM as RefLM
from repro.models.params import ParamSpec as RefParamSpec
from repro_torch.configs import get_config
from repro_torch.core.device import rank_device
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import blocks as PB
from repro_torch.models.lm import LM
from repro_torch.models.params import tree_paths
from repro_torch.parallel import sharding as S
from repro_torch.serving.engine import Engine

ARCHS = list_archs()
DEGREES = (2, 4, 8)
CASES = [pytest.param(a, r, tp, id=f"{a}-{'smoke' if r else 'full'}-{tp}")
         for a in ARCHS for r in (True, False) for tp in DEGREES]


def _ref_ctx(cfg, tp):
    return ref_sharding.make_serving_ctx(
        cfg, SimpleNamespace(shape={"model": tp}, axis_names=("model",)))


def _port_ctx(cfg, tp, rank=0, device="cpu", backend="gloo"):
    mesh = SimpleNamespace(shape={"data": 1, "model": tp},
                           axis_names=("data", "model"), rank=rank,
                           device=torch.device(device), backend=backend)
    return S.ShardCtx(mesh, cfg)


def _ref_path(path: str) -> str:
    return "".join(f"['{k}']" for k in path.split("/"))


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's NamedSharding returns its spec (no real mesh)."""
    for mod in (ref_sharding, ref_engine):
        monkeypatch.setattr(mod, "NamedSharding",
                            lambda mesh, spec, **kw: spec)


@pytest.mark.parametrize("arch,reduced,tp", CASES)
def test_resolver_matches_reference(arch, reduced, tp, bare_specs):
    """Every param leaf: the dim the port's resolver splits is the dim of
    the reference's ``state_shardings(component="params")``."""
    rcfg = ref_config(arch, reduced=reduced)
    specs = RefLM(rcfg).param_specs()
    shapes = jax.tree_util.tree_map(
        lambda ps: jax.ShapeDtypeStruct(ps.shape, ps.dtype), specs,
        is_leaf=lambda x: isinstance(x, RefParamSpec))
    want = ref_sharding.state_shardings(
        _ref_ctx(rcfg, tp), shapes, ref_sharding.logical_by_path_of(specs),
        component="params")
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))
    want = {jax.tree_util.keystr(p): tuple(spec) for p, spec in flat}

    cfg = get_config(arch, reduced=reduced)
    ctx = _port_ctx(cfg, tp)
    port_specs = dict(tree_paths(
        LM(cfg, device="cpu").param_specs(),
        is_leaf=lambda x: isinstance(x, S.ParamSpec)))
    assert {_ref_path(p) for p in port_specs} == set(want)
    for path, ps in port_specs.items():
        got = S.resolve_spec(ctx, path, ps.shape, ps.logical)
        assert got == want[_ref_path(path)], path


@pytest.mark.parametrize("arch,reduced,tp", CASES)
def test_pool_specs_match_reference(arch, reduced, tp, bare_specs):
    """The pools the port allocates on a rank are cut on the axis of the
    reference's specs: the paged pool's KV heads (``spec_for("kv_pool")``),
    the SSM slot pool's conv channels and SSD heads (the reference
    engine's ``_ssm_sharding_tree``; the port's conv cut keeps B and C
    whole)."""
    rcfg = ref_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    rctx, ctx = _ref_ctx(rcfg, tp), _port_ctx(cfg, tp)
    k, hd = max(cfg.n_kv_heads, 1), max(cfg.head_dim, 1)
    # the pools the port allocates: split on the reference's axis
    k_held = LM(cfg, device="cpu", ctx=ctx).kv_heads_held()
    assert (k_held < k if cfg.n_kv_heads else False) == (
        rctx.spec_for("kv_pool", (2, 9, 16, k, hd))[3] is not None)
    if cfg.ssm_state:
        base = RB.ssm_init_cache(rcfg, 8)
        states = {"pos0": {leaf: SimpleNamespace(
            shape=(3,) + tuple(a.shape), ndim=a.ndim + 1)
            for leaf, a in base.items()}}
        want = ref_engine.Engine._ssm_sharding_tree(
            SimpleNamespace(_ctx=rctx, mesh=None), states)
        local = PB.ssm_init_cache(cfg, 8, ctx=ctx)
        for leaf, spec in want["pos0"].items():
            got = (3,) + tuple(local[leaf].shape)
            assert tuple("model" if g < f else None for g, f in zip(
                got, states["pos0"][leaf].shape)) == tuple(spec), leaf


_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_INT[t.element_size()])


def _reassemble(cfg, tp, path, shards, full):
    """The full leaf from every rank's shard: cut components
    concatenated over the ranks, whole ones read from rank 0 (and equal
    on every rank)."""
    spec = S.resolve_spec(_port_ctx(cfg, tp), path, tuple(full.shape),
                          S.logical_by_path_of(
                              LM(cfg, device="cpu").param_specs())[path])
    if "model" not in spec:
        for s in shards:
            assert s is full or torch.equal(s, full)
        return shards[0]
    dim = spec.index("model")
    pieces, starts = [], [0] * tp
    for n, cut in S.fused_segments(path.rsplit("/", 1)[-1], cfg,
                                   full.shape[dim]):
        w = n // tp if cut else n
        segs = [s.narrow(dim, starts[r], w) for r, s in enumerate(shards)]
        starts = [st + w for st in starts]
        if cut:
            pieces.append(torch.cat(segs, dim))
        else:
            assert all(torch.equal(x, segs[0]) for x in segs)
            pieces.append(segs[0])
    assert all(st == s.shape[dim] for st, s in zip(starts, shards))
    return torch.cat(pieces, dim)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama2-7b",
                                  "granite-3-2b", "mamba2-130m"])
def test_shard_params_round_trip(arch, tp):
    """The ranks' shards put back together are the full tree, bit for
    bit; each rank's SSM in_proj is 2·di/tp + 2·G·N + H/tp wide."""
    cfg = get_config(arch, reduced=True)
    params = LM(cfg, device="cpu").init(0)
    shards = [S.shard_params(params, _port_ctx(cfg, tp, r))
              for r in range(tp)]
    flat = [dict(tree_paths(s)) for s in shards]
    for path, full in tree_paths(params):
        got = _reassemble(cfg, tp, path, [f[path] for f in flat], full)
        assert got.dtype == full.dtype and got.shape == full.shape, path
        assert torch.equal(_bits(got), _bits(full)), path
    if cfg.ssm_state:
        gn = cfg.ssm_ngroups * cfg.ssm_state
        w = flat[0]["blocks/pos0/mix/in_proj"].shape[-1]
        assert w == 2 * cfg.d_inner // tp + 2 * gn + cfg.n_ssm_heads // tp


def test_kv_part_refuses_uneven_groups():
    """q heads whose KV heads cannot be read as an even grouping raise
    (6 q heads over 3 KV heads at tp 2: rank 0's heads 0-2 read KV heads
    0, 0, 1)."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", reduced=True),
                              n_heads=6, n_kv_heads=3)
    with pytest.raises(NotImplementedError, match="unevenly"):
        _port_ctx(cfg, 2).kv_part(cfg)
    assert _port_ctx(cfg, 3, rank=2).kv_part(cfg) == (2, 3)


def _fake_mesh(tp=2, device="cpu", backend="gloo"):
    return _port_ctx(None, tp, device=device, backend=backend).mesh


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    return cfg, LM(cfg, device="cpu").init(0)


@pytest.mark.parametrize("n_experts,tp", [(4, 2), (6, 4)])
def test_moe_refused_under_tp(n_experts, tp):
    """Named for the refusal it held until expert parallelism was
    ported: the model-parallel engine now takes MoE archs. qwen3-moe
    smoke's expert leaves at degree 2 are cut on the experts axis (each
    rank its E/tp experts, whole); with 6 experts at degree 4, which
    does not divide them, on the MLP axis (every expert, d_ff/tp wide),
    as the reference's resolver ranks the axes; the router stays
    whole. Every rank's pieces, put back together, are the tree; drawn
    directly (``LM.init(seed, pieces=True)``) they are the same
    pieces."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", reduced=True),
                              n_experts=n_experts)
    rcfg = dataclasses.replace(ref_config("qwen3-moe-30b-a3b", reduced=True),
                               n_experts=n_experts)
    params = LM(cfg, device="cpu").init(0)
    ffn = params["blocks"]["pos0"]["ffn"]
    e, d, f = n_experts, cfg.d_model, cfg.d_ff
    ep = e % tp == 0
    ref = ref_sharding.resolve_spec(_ref_ctx(rcfg, tp), "w_gate",
                                    tuple(ffn["w_gate"].shape),
                                    ("layers", "experts", "embed", "mlp"),
                                    zero=False)
    assert tuple(ref) == ((None, "model", None, None) if ep else
                          (None, None, None, "model"))
    pieces = []
    for rank in range(tp):
        ctx = _port_ctx(cfg, tp, rank=rank)
        assert PB.uses_ep(cfg, ctx) == ep
        local = S.shard_params(params, ctx)["blocks"]["pos0"]["ffn"]
        assert local["router"].shape == ffn["router"].shape
        n = cfg.n_layers // LM(cfg, device="cpu").period
        want = (n, e // tp, d, f) if ep else (n, e, d, f // tp)
        assert tuple(local["w_gate"].shape) == want
        assert tuple(local["w_down"].shape) == (
            (n, e // tp, f, d) if ep else (n, e, f // tp, d))
        drawn = LM(cfg, device="cpu", ctx=ctx).init(0, pieces=True)
        for (pa, a), (pb, b) in zip(tree_paths(S.shard_params(params, ctx)),
                                    tree_paths(drawn)):
            assert pa == pb and torch.equal(a, b), pa
        pieces.append(local)
        Engine(cfg, params, mesh=ctx.mesh, max_batch=2, n_blocks=8)
    for key in ("w_gate", "w_up", "w_down"):
        dim = 1 if ep else (3 if key != "w_down" else 2)
        assert torch.equal(torch.cat([p[key] for p in pieces], dim),
                           ffn[key])


def test_mesh_requires_fused_mode(qwen):
    cfg, params = qwen
    with pytest.raises(ValueError, match="model-parallel"):
        Engine(cfg, params, mode="legacy", mesh=_fake_mesh())


def test_gloo_on_the_card_refuses_cuda_graphs(qwen):
    """A gloo mesh on CUDA tensors with capture on raises before the
    engine touches a device; with capture off it goes on to need a card
    (none here)."""
    cfg, params = qwen
    mesh = _fake_mesh(device="cuda:0")
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        Engine(cfg, params, mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(cfg, params, mesh=mesh, cuda_graphs=False)


def test_deadlines_refused_under_tp(qwen):
    cfg, params = qwen
    with pytest.raises(ValueError, match="deadlines"):
        Engine(cfg, params, mesh=_fake_mesh(), default_deadline_s=1.0)
    eng = Engine(cfg, params, mesh=_fake_mesh(), max_batch=2, n_blocks=8)
    with pytest.raises(ValueError, match="deadlines"):
        eng.arm_deadlines()


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    with pytest.raises(ValueError, match="gloo"):
        rank_device(0, 2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        rank_device(0, 2, "mpi", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        rank_device(0, 2, "nccl")
    # a 2-D mesh (TP training) is refused only for what nccl refuses:
    # its four ranks on one card, before any group is joined
    with pytest.raises(RuntimeError, match="one card per rank"):
        make_local_mesh(model=2, data=2, backend="nccl", rank=0,
                        init_method="file:///nonexistent")


def test_single_rank_shard_is_the_tree(qwen):
    """At tp 1 every leaf is the rank's as it is."""
    cfg, params = qwen
    shard = S.shard_params(params, _port_ctx(cfg, 1))
    for (p, a), (q, b) in zip(tree_paths(params), tree_paths(shard)):
        assert p == q and a is b


def test_bridge_carries_reference_params_to_a_shard():
    """``bridge.shard_from_jax``: the reference's numpy params to a rank's
    shard, bit for bit the shard of the bridged tree."""
    from repro_torch.bridge import from_jax_numpy, shard_from_jax
    params = jax.device_get(RefLM(ref_config("mamba2-130m", reduced=True))
                            .init(jax.random.PRNGKey(0)))
    cfg = get_config("mamba2-130m", reduced=True)
    full = from_jax_numpy(params)
    for rank in range(2):
        ctx = _port_ctx(cfg, 2, rank)
        want = dict(tree_paths(S.shard_params(full, ctx)))
        for path, got in tree_paths(shard_from_jax(params, ctx)):
            assert torch.equal(_bits(got), _bits(want[path])), path


# tests/test_kernels.py:22-23, the reference kernel test's tolerances
_RMS_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_split_rmsnorm_matches_reference_whole_row(tp, dtype):
    """``rmsnorm_split`` on each of ``tp`` parts of a row (each part's f32
    sum of squares, added over the parts in place of the all_reduce)
    against the reference's RMSNorm of the whole row (its Pallas kernel
    in interpret mode), mamba2 smoke's gated norm width."""
    rng = np.random.default_rng(tp)
    n = get_config("mamba2-130m", reduced=True).d_inner
    scale = 10.0 ** rng.uniform(-3, 1, (12, 1))
    x = (rng.standard_normal((12, n)) * scale).astype(np.float32)
    w = (rng.standard_normal(n) + 1.0).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    parts = list(zip(xt.chunk(tp, -1), wt.chunk(tp)))
    sums = [trn.rmsnorm_sumsq_plain(p) for p, _ in parts]

    def reduce(ss):            # what the ranks' all_reduce leaves in ss
        ss.copy_(torch.stack(sums).sum(0))
        return ss

    before = dict(trn.LAUNCHES)
    got = torch.cat([trn.rmsnorm_split(p, q, n, reduce)[0]
                     for p, q in parts], -1)
    assert dict(trn.LAUNCHES) == before          # CPU: the plain passes
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = rops.rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_RMS_TOL[dtype])
    if tp == 1:                # one part is the whole-row plain version
        torch.testing.assert_close(got, trn.rmsnorm_plain(xt, wt),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("w_shape", "w "), ("ss_dtype", "ss "),
    ("ss_shape", "ss "), ("narrow_n", "narrower"), ("dtype", "f32 or bf16")])
def test_split_rmsnorm_wrappers_refuse_bad_inputs(case, match):
    """The two passes' CUDA wrappers check before they load or launch
    anything, so their checks run on host tensors too."""
    x, w = torch.zeros((4, 64)), torch.zeros(64)
    ss, n = torch.zeros((4, 1)), 128
    if case == "w_shape":
        w = torch.zeros(32)
    elif case == "ss_dtype":
        ss = ss.double()
    elif case == "ss_shape":
        ss = torch.zeros(4)
    elif case == "narrow_n":
        n = 32
    elif case == "dtype":
        x = x.half()
    before = dict(trn.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        if case in ("cpu", "dtype"):
            trn._sumsq_cuda(x)
        trn._scaled_cuda(x, w, ss, n)
    assert dict(trn.LAUNCHES) == before


def _window_case(quant: bool, transposed: bool = False):
    """A pool of 2 KV heads (n_blocks, bs, K, D) and the window of its
    second head, with 4 q heads reading it."""
    g = torch.Generator().manual_seed(0)
    k = torch.randn((6, 16, 2, 64), generator=g).bfloat16()
    v = torch.randn((6, 16, 2, 64), generator=g).bfloat16()
    ks = vs = None
    if quant:
        k, v = k.to(torch.int8), v.to(torch.int8)
        ks, vs = torch.rand((6, 16, 2, 1)), torch.rand((6, 16, 2, 1))
    win = [None if a is None else a[:, :, 1:2] for a in (k, v, ks, vs)]
    if transposed:
        win[0] = k.transpose(1, 2).contiguous().transpose(1, 2)[:, :, 1:2]
    q = torch.randn((2, 1, 4, 64), generator=g).bfloat16()
    table = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
    lengths = torch.tensor([20, 40], dtype=torch.int32)
    return q, win[0], win[1], table, lengths, win[2], win[3]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_wrapper_takes_a_window_of_the_pool(quant):
    """A rank that holds every KV head reads those its q heads map to in
    place: the CUDA wrapper takes that window of the pool (its checks all
    pass, up to the one asking for a card), refuses any other strided
    layout, and the plain read of the window is the read of its copy."""
    args = _window_case(quant)
    assert not args[1].is_contiguous()
    assert tfd._pool_heads(args[1]) == 2
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd._paged_mq_cuda(*args)
    with pytest.raises(ValueError, match="window"):
        tfd._paged_mq_cuda(*_window_case(quant, transposed=True))
    copy = [a if a is None or a.is_contiguous() else a.contiguous()
            for a in args]
    got = tfd.paged_flash_prefix_partial(
        *args[:5], k_scale=args[5], v_scale=args[6])
    want = tfd.paged_flash_prefix_partial(
        *copy[:5], k_scale=copy[5], v_scale=copy[6])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
