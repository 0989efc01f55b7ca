"""The port's ZeRO placement and gradient compressor against the
reference's (``repro.parallel.sharding``, ``repro.train.step``,
``repro.parallel.compression``), with no processes.

The reference's resolver answers on a one-device CPU when its
``ShardCtx`` holds a stand-in mesh (``shape`` and ``axis_names``); its
``NamedSharding`` is patched to hand back the bare spec and whether the
sharding's memory kind is pinned host memory. For every leaf of the
train state of all 13 configs, smoke and full width (the reference's
abstract state from ``jax.eval_shape``, the port's from its own specs),
under Naive, Z1, Z2, Z3 and Z3+O, and Q8+Z3 and L+Z3 at smoke size, on
the meshes (data, model) = (2, 1), (4, 1) and (2, 2), and in sequence
mode (``attn_mode`` "seq", and "auto" where it turns to it) on (1, 2),
(2, 2) and (2, 3), the port places params, gradients and optimizer state
(spec and host flag) where the reference does. The reference's own ZeRO claim holds on the port, and
the int8 compressor equals the reference's bit for bit."""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.parallel.sharding as ref_sharding
from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.core.config import ShapeSpec as RefShapeSpec
from repro.core.config import technique_from_label as jtech
from repro.launch.build import pick_grad_accum as ref_pick_grad_accum
from repro.models.lm import LM as RefLM
from repro.parallel import compression as RC
from repro.train.step import init_train_state as ref_init
from repro.train.step import train_state_shardings as ref_train_shardings
from repro_torch.configs import get_config
from repro_torch.core.config import ShapeSpec, technique_from_label
from repro_torch.launch.build import pick_grad_accum
from repro_torch.launch.mesh import mesh_groups
from repro_torch.models.lm import LM
from repro_torch.models.params import ParamSpec, keystr_paths, set_path, \
    tree_paths
from repro_torch.parallel import compression as C
from repro_torch.parallel import sharding as S
from repro_torch.train.step import check_dp, init_train_state

ARCHS = list_archs()
MESHES = ((2, 1), (4, 1), (2, 2))
SEQ_MESHES = ((1, 2), (2, 2), (2, 3))
FLOAT = ("Naive", "Z1", "Z2", "Z3", "Z3+O")
CASES = ([pytest.param(a, r, t, id=f"{a}-{'smoke' if r else 'full'}-{t}")
          for a in ARCHS for r in (True, False) for t in FLOAT]
         + [pytest.param(a, True, t, id=f"{a}-smoke-{t}")
            for a in ARCHS for t in ("Q8+Z3", "L+Z3")])


class _Pl:
    """The patched reference NamedSharding: spec and host flag."""

    def __init__(self, mesh, spec, **kw):
        self.value = (tuple(spec), kw.get("memory_kind") == "pinned_host")


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Pl)
    monkeypatch.setattr(jax.sharding, "NamedSharding", _Pl)


def _mesh(data, model):
    return SimpleNamespace(shape={"data": data, "model": model},
                           axis_names=("data", "model"), rank=0, data_rank=0)


@functools.lru_cache(maxsize=None)
def _ref_state(arch, reduced, kind):
    """The reference's abstract train state (``kind``: "float" for the
    techniques whose state is the bf16 params and f32 moments)."""
    cfg = ref_config(arch, reduced=reduced)
    model = RefLM(cfg)
    tech = jtech("Naive" if kind == "float" else kind)
    state = jax.eval_shape(lambda r: ref_init(model, tech, r)[0],
                           jax.random.PRNGKey(0))
    return cfg, model, state


def _port_state(arch, reduced, label):
    """The port's train state: real at smoke size for the quantized and
    LoRA techniques; for the float ones (every width) its structure on
    the meta device, as ``init_train_state`` builds it (bf16 params, f32
    moments, int32 counters)."""
    cfg = get_config(arch, reduced=reduced)
    model = LM(cfg, device="cpu")
    if label not in FLOAT:
        return cfg, model, init_train_state(
            model, technique_from_label(label))[0]
    params, m = {}, {}
    for path, ps in tree_paths(model.param_specs(),
                               is_leaf=lambda x: isinstance(x, ParamSpec)):
        set_path(params, path, torch.empty(ps.shape, dtype=ps.dtype,
                                           device="meta"))
        set_path(m, path, torch.empty(ps.shape, device="meta"))
    step = torch.empty((), dtype=torch.int32, device="meta")
    return cfg, model, {"params": params, "opt": {"m": m, "v": m,
                                                  "step": step},
                        "step": step}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Pl))
    return {jax.tree_util.keystr(p): pl.value for p, pl in flat}


def _port_flat(tree):
    return {p: (pl.spec, pl.host) for p, pl in keystr_paths(tree)}


def _placed_alike(rcfg, rmodel, rstate, cfg, model, pstate, label, mesh,
                  mode=None):
    """Both packages' contexts of ``label`` (``attn_mode`` ``mode``
    where given) on ``mesh`` (data, model): the same axes and attention
    mode, and every leaf of params, grads and optimizer state placed
    alike. Returns the port's placements."""
    rtech, tech = jtech(label), technique_from_label(label)
    if mode is not None:
        rtech = dataclasses.replace(rtech, attn_mode=mode)
        tech = dataclasses.replace(tech, attn_mode=mode)
    rlogical = ref_sharding.logical_by_path_of(rmodel.param_specs())
    logical = S.logical_by_keystr_of(model.param_specs())
    rctx = ref_sharding.make_shard_ctx(rcfg, rtech, _mesh(*mesh))
    ctx = S.make_shard_ctx(cfg, tech, _mesh(*mesh))
    assert (ctx.dp_axes, ctx.model_axis, ctx.dp_size, ctx.attn_mode) \
        == (rctx.dp_axes, rctx.model_axis, rctx.dp_size, rctx.attn_mode)
    want = _ref_flat(ref_train_shardings(rstate, rmodel, rctx))
    want.update({"grads" + p: v for p, v in _ref_flat(
        ref_sharding.state_shardings(rctx, rstate["params"], rlogical,
                                     component="grads")).items()})
    got = _port_flat(S.train_state_shardings(pstate, model, ctx))
    got.update({"grads" + p: v for p, v in _port_flat(
        S.state_shardings(ctx, pstate["params"], logical,
                          component="grads")).items()})
    assert set(got) == set(want), (mesh, mode,
                                   sorted(set(got) ^ set(want))[:4])
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, (mesh, mode, list(bad.items())[:3])
    return got, ctx


@pytest.mark.parametrize("arch,reduced,label", CASES)
def test_zero_placements_match_reference(arch, reduced, label, bare_specs):
    """params, grads and optimizer state: every leaf's spec and host flag
    equal the reference's ``train_state_shardings`` /
    ``state_shardings(component="grads")``, on each mesh, and in
    sequence mode (explicit, and "auto" where the reference turns to it)
    on each of ``SEQ_MESHES``; the port picks the reference's attention
    mode on each."""
    kind = label if label not in FLOAT else "float"
    rcfg, rmodel, rstate = _ref_state(arch, reduced, kind)
    cfg, model, pstate = _port_state(arch, reduced, label)
    rlogical = ref_sharding.logical_by_path_of(rmodel.param_specs())
    logical = S.logical_by_keystr_of(model.param_specs())
    assert logical == rlogical
    for data, mdl in MESHES:
        got, ctx = _placed_alike(rcfg, rmodel, rstate, cfg, model, pstate,
                                 label, (data, mdl))
        assert ctx.attn_mode == "head"
        if label in ("Z3", "Z3+O") and mdl == 1:
            # ZeRO-3 splits every leaf some dim of which the ranks divide
            assert any("data" in str(s) for s, _ in got.values())
    for mesh in SEQ_MESHES:
        for mode in ("seq", "auto"):
            _placed_alike(rcfg, rmodel, rstate, cfg, model, pstate, label,
                          mesh, mode)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama2-7b"])
def test_sequence_mode_raises(arch, bare_specs):
    """A model axis of 3 divides neither model's heads (16 and 32), where
    the reference turns to sequence mode: the port's context, which once
    raised here, now turns to it too, and under Z3 its placements equal
    the reference's ``state_shardings`` for every leaf, the attention
    leaves whole on the model axis (cut over the data axis only)."""
    rcfg, rmodel, rstate = _ref_state(arch, False, "float")
    cfg, model, pstate = _port_state(arch, False, "Z3")
    got, ctx = _placed_alike(rcfg, rmodel, rstate, cfg, model, pstate, "Z3",
                             (2, 3))
    assert ctx.attn_mode == "seq"
    for p, (spec, _) in got.items():
        if any(w in p for w in ("['wq']", "['wk']", "['wv']", "['wo']")):
            assert "model" not in spec, p


def test_claim2_zero_stage_changes_param_sharding_on_the_port():
    """tests/test_paper_claims.py:104 on the port's resolver: Z3 shards
    parameters over DP, Z2 leaves them replicated."""
    cfg = get_config("granite-3-2b")
    for stage, expect_dp in ((2, False), (3, True)):
        ctx = S.make_shard_ctx(cfg, dataclasses.replace(
            technique_from_label("Naive"), zero_stage=stage),
            _mesh(16, 16))
        spec = S.resolve_spec(ctx, "w_up", (40, 2048, 8192),
                              ("layers", "embed", "mlp"),
                              zero=(stage >= 3))
        has_dp = "data" in jax.tree_util.tree_leaves(tuple(spec))
        assert has_dp == expect_dp, (stage, spec)


@pytest.mark.parametrize("data,rows", [(2, 4), (4, 8), (2, 2)])
def test_batch_rows_follow_the_batch_spec(data, rows):
    """Rank r holds rows [r B/dp, (r+1) B/dp): P(dp, None) over a batch."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    got = []
    for r in range(data):
        mesh = SimpleNamespace(shape={"data": data, "model": 1},
                               axis_names=("data", "model"), rank=0,
                               data_rank=r)
        ctx = S.make_shard_ctx(cfg, technique_from_label("Z3"), mesh)
        assert ctx.dp_spec_entry == "data"
        got.append(ctx.batch_sharding(rows))
    w = rows // data
    assert got == [(r * w, (r + 1) * w) for r in range(data)]


@pytest.mark.parametrize("arch,batch,seq,data", [
    ("qwen1.5-0.5b", 4, 2048, 2), ("qwen1.5-0.5b", 256, 4096, 4),
    ("llama2-7b", 8, 4096, 2), ("mamba2-130m", 16, 1024, 8)])
def test_pick_grad_accum_matches_reference(arch, batch, seq, data):
    rcfg, cfg = ref_config(arch), get_config(arch)
    tech = technique_from_label("F+R+Z3")
    rctx = ref_sharding.make_shard_ctx(rcfg, jtech("F+R+Z3"),
                                       _mesh(data, 1))
    ctx = S.make_shard_ctx(cfg, tech, _mesh(data, 1))
    assert pick_grad_accum(cfg, ShapeSpec("t", seq, batch, "train"), ctx) \
        == ref_pick_grad_accum(rcfg, RefShapeSpec("t", seq, batch, "train"),
                               rctx)
    assert pick_grad_accum(cfg, ShapeSpec("t", seq, batch, "train"),
                           None) == 1


def test_pick_grad_accum_divides_a_ranks_rows():
    """12 rows over 4 ranks: the reference picks 2 micro-batches of 6
    global rows (GSPMD places them); a rank's 3 rows do not split in
    two, so the port halves the count to 1."""
    rcfg, cfg = ref_config("qwen1.5-0.5b"), get_config("qwen1.5-0.5b")
    rctx = ref_sharding.make_shard_ctx(rcfg, jtech("F+R+Z3"), _mesh(4, 1))
    ctx = S.make_shard_ctx(cfg, technique_from_label("F+R+Z3"), _mesh(4, 1))
    assert ref_pick_grad_accum(rcfg, RefShapeSpec("t", 2048, 12, "train"),
                               rctx) == 2
    assert pick_grad_accum(cfg, ShapeSpec("t", 2048, 12, "train"), ctx) == 1


def test_mesh_layout_and_two_axes_refused():
    """Global rank d * model + m, as jax.make_mesh((data, model)) lays
    devices out (each model row and data column a group of the mesh).
    Both axes above 1 now train every family but the encoder-decoder
    one (tests/test_torch_tp_train.py, tests/
    test_torch_tp_train_families.py); on such a mesh the context keeps the model
    axis for TP and the data axis for ZeRO, folds the model axis into the
    data axes without TP (their collectives over every rank), and the
    families and techniques TP training has not reached refuse, naming
    their items."""
    rows, cols = mesh_groups(model=3, data=2)
    assert rows == [[0, 1, 2], [3, 4, 5]]
    assert cols == [[0, 3], [1, 4], [2, 5]]
    want = np.arange(6).reshape(2, 3)
    assert rows == want.tolist() and cols == want.T.tolist()
    mesh = _mesh(2, 2)
    ctx = S.make_shard_ctx(get_config("qwen1.5-0.5b"),
                           technique_from_label("F+R+Z3"), mesh)
    assert (ctx.dp_axes, ctx.model_axis, ctx.size, ctx.dp_size) == (
        ("data",), "model", 2, 2)
    no_tp = dataclasses.replace(technique_from_label("F+R"), tp=False)
    for arch, tech in (("qwen1.5-0.5b", no_tp),
                       ("mamba2-130m", technique_from_label("F+R+Z3"))):
        fold = S.make_shard_ctx(get_config(arch), tech, mesh)
        assert (fold.dp_axes, fold.model_axis, fold.size,
                fold.dp_size) == (("data", "model"), None, 1, 4)
    for arch, label, item in (("seamless-m4t-large-v2", "F+R", "7.10"),
                              ("jamba-v0.1-52b", "Q8+F+R+Z2", "7.11"),
                              ("qwen1.5-0.5b", "L+F+R", "7.11")):
        cfg = get_config(arch)
        tech = technique_from_label(label)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            check_dp(cfg, tech, S.make_shard_ctx(cfg, tech, mesh))


def _folded_ranks(arch, reduced, label, data=2, model=3):
    """Every rank of a (data x model) mesh as mamba2 trains on it (its
    ``dp_over_model`` folds the model axis into the data axes): each
    rank's context and :class:`train.step.DPLayout`, global rank order."""
    from repro_torch.launch.build import make_model
    from repro_torch.train.step import DPLayout
    cfg = get_config(arch, reduced=reduced)
    tech = technique_from_label(label)
    out = []
    for d in range(data):
        for m in range(model):
            mesh = SimpleNamespace(shape={"data": data, "model": model},
                                   axis_names=("data", "model"), rank=m,
                                   data_rank=d)
            ctx = S.make_shard_ctx(cfg, tech, mesh)
            out.append((ctx, DPLayout(make_model(cfg, tech, device="cpu",
                                                 ctx=ctx), tech, ctx)))
    return out


@pytest.mark.parametrize("label", ["F+R+Z1", "F+R+Z3"])
def test_folded_2d_mesh_writes_each_piece_once(label):
    """mamba2-130m on a (2 x 3) mesh: its data axes are (data, model), and
    the leaves whose largest dim 6 does not divide but 2 does (in_proj's
    3,352, the conv's 1,792) are cut over the data axis alone, so the
    three model ranks of a data column hold the same piece. Of the ranks
    that hold a piece exactly one writes it into an exact gather and
    counts it in the gradient's norm: for params, gradients and moments
    the writers' pieces of every leaf tile it once."""
    ranks = _folded_ranks("mamba2-130m", False, label)
    ctx0, lay0 = ranks[0]
    assert ctx0.dp_axes == ("data", "model") and ctx0.dp_size == 6
    prefix = [p for p, c in lay0.opt.items() if c.dim is not None
              and c.parts == 2]
    assert any("in_proj" in p for p in prefix), prefix
    for table in ("param", "grad", "opt"):
        for path, shape in lay0.shapes.items():
            spans = []
            for _, lay in ranks:
                c = getattr(lay, table)[path]
                if c.writes:
                    n = 1 if c.dim is None else shape[c.dim]
                    spans.append(c.bounds(n) if c.dim is not None
                                 else (0, n))
            n = spans[0][1] if len(spans) == 1 else shape[
                getattr(lay0, table)[path].dim]
            assert sorted(spans) == [(i * n // len(spans),
                                      (i + 1) * n // len(spans))
                                     for i in range(len(spans))], (
                table, path, spans)


def _sum_calls(bufs) -> None:
    """Each collective call's buffers (one list a rank, in the order the
    rank called) summed as an int32 all-reduce sums them, in place."""
    for call in zip(*bufs):
        total = torch.stack(call).sum(0, dtype=torch.int32)
        for b in call:
            b.copy_(total)


@pytest.mark.parametrize("label", ["F+R+Z1", "F+R+Z3"])
def test_folded_2d_mesh_gathers_are_exact(label):
    """The gathers of the reduced mamba2 on a (2 x 3) mesh (296-wide
    in_proj and 160-wide conv cut over the data axis alone), emulated in
    one process: each of the six ranks writes its pieces into its zero
    int32 buffer, the buffers are summed as the all-reduce sums them, and
    every rank reads every leaf back bit for bit, both as a whole
    (``zero.gather_leaf``: the ZeRO-1/2 param gather and the checkpoint's)
    and a layer at a time as ZeRO-3 gathers at use
    (``zero.gather_used``)."""
    from repro_torch.parallel import zero as Z
    ranks = _folded_ranks("mamba2-130m", True, label)
    assert any(c.parts == 2 for c in ranks[0][1].opt.values()
               if c.dim is not None)
    gen = torch.Generator().manual_seed(0)
    whole = {p: torch.randn(s, generator=gen).to(torch.bfloat16)
             for p, s in ranks[0][1].shapes.items()}
    tables = ("opt", "param") if label == "F+R+Z3" else ("opt",)
    for table in tables:
        bufs, got = [], []
        for ctx, lay in ranks:
            bufs.append([])
            ctx.dp_gather_bytes = bufs[-1].append
            cuts = getattr(lay, table)
            got.append({p: Z.gather_leaf(ctx, Z.take(w, cuts[p]), w.shape,
                                         cuts[p])
                        for p, w in whole.items()})
        _sum_calls(bufs)
        for g in got:
            for p, w in whole.items():
                assert torch.equal(g[p].view(torch.int16),
                                   w.view(torch.int16)), (table, p)
    if label == "F+R+Z3":
        stacked = {p: w for p, w in whole.items() if "blocks" in p}
        bufs, got = [], []
        for ctx, lay in ranks:
            bufs.append([])
            ctx.dp_gather_bytes = bufs[-1].append
            comm = Z.ZeroComm(ctx, torch.device("cpu"), torch.zeros(
                (), requires_grad=True))
            tree = {p: Z.Shard.of(Z.take(w, lay.param[p]), w.shape,
                                  lay.param[p], None, comm)
                    for p, w in stacked.items()}
            n = next(iter(stacked.values())).shape[0]
            got.append([Z.gather_used(t) for t in Z.unstack(tree, n)])
        _sum_calls(bufs)
        for g in got:
            for i, layer in enumerate(g):
                for p, w in stacked.items():
                    assert torch.equal(layer[p].view(torch.int16),
                                       w[i].view(torch.int16)), (p, i)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", [512, C.BLOCK, 2 * C.BLOCK + 300, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressor_matches_reference_bitwise(n, dtype):
    """``compress_grad`` (codes, scales, the new error carry) and
    ``decompress_grad`` equal the reference's bit for bit, on a seeded
    gradient (f32 or bf16) with a seeded f32 error carry, also where the
    length is not a whole number of blocks."""
    rng = np.random.default_rng(n)
    g32 = (rng.standard_normal(n) * rng.uniform(1e-3, 10, n)).astype(
        np.float32)
    err = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    jg = jnp.asarray(g32).astype(dtype)
    tg = torch.from_numpy(g32).to(getattr(torch, dtype))
    rq, rs, rerr = RC.compress_grad(jg, jnp.asarray(err))
    q, s, new_err = C.compress_grad(tg, torch.from_numpy(err))
    assert np.array_equal(np.asarray(rq), q.numpy())
    assert np.array_equal(_bits(rs), _bits(s.numpy()))
    assert np.array_equal(_bits(rerr), _bits(new_err.numpy()))
    rd = RC.decompress_grad(rq, rs, (n,))
    d = C.decompress_grad(q, s, (n,))
    assert np.array_equal(_bits(rd), _bits(d.numpy()))


def test_grad_compression_error_feedback_converges():
    """tests/test_substrate.py:185 on the port: the accumulated
    reconstruction tracks the accumulated gradient (the bias does not
    build up)."""
    g = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (512,), jnp.float32)))
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(8):
        q, s, err = C.compress_grad(g, err)
        total += C.decompress_grad(q, s, g.shape)
    rel = float(torch.linalg.norm(total - 8 * g) / torch.linalg.norm(8 * g))
    assert rel < 0.01, rel
