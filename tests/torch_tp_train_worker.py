"""Rank body of tests/test_torch_tp_train.py. The spawned ranks import
this module to unpickle their function, so it imports torch and the port
only, never JAX.

``run_all(mesh, plan)`` runs every case of ``plan`` in turn on one set
of ranks, as ``torch_dp_worker.run_all`` does: a case is ``(name, kind,
kwargs)``; a kwargs' ``oracle`` runs it on one device, on global rank 0
alone. Each rank returns ``{name: result}``."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.perfscope import Timer
from repro_torch.launch.build import make_model
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import lm as LMmod
from repro_torch.models.params import keystr_paths, tree_map
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel.sharding import (MODEL, make_shard_ctx,
                                           train_state_shardings)
from repro_torch.train.step import (DPLayout, build_train_step,
                                    init_train_state, logical_train_state,
                                    shard_train_state)

from torch_dp_worker import OPT, host, technique


@contextlib.contextmanager
def logits_widths(out: list):
    """Record the width of every logits block the vocab-parallel loss
    takes (``models.lm.vocab_parallel_ce``)."""
    orig = LMmod.vocab_parallel_ce

    def recorded(logits, labels, lo, ctx):
        out.append(int(logits.shape[-1]))
        return orig(logits, labels, lo, ctx)

    LMmod.vocab_parallel_ce = recorded
    try:
        yield
    finally:
        LMmod.vocab_parallel_ce = orig


def train(mesh, arch, label, batches, *, accum=1, start=None, sp=False,
          pieces=False, attn_mode="auto", heads=None):
    """Steps of ``label`` on the reduced ``arch`` (with ``heads`` query
    and KV heads where given) over ``batches`` (whole global batches as
    numpy): on one device when ``mesh`` is None (the whole batch in
    ``accum`` micro-batches), else as this rank of the mesh with the
    attention mode ``attn_mode``. The state starts from the seed, or
    from ``start`` (a whole one-device state). Returns each step's loss
    (bits and float), ce, grad_norm, the collectives, seams and k/v
    collectives a step (``ShardCtx.comm_timer``), the context's
    attention mode, the widths of the logits blocks, the whole state's
    bits after the first step (``state1``) and after the last
    (``state``) and, with ``pieces``, this rank's own pieces' bits and
    the cut each should be of the whole by ``state_shardings``."""
    cfg = get_config(arch, reduced=True)
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    tech = technique(label, accum, sp=sp, attn_mode=attn_mode)
    ctx = make_shard_ctx(cfg, tech, mesh) if mesh is not None else None
    model = make_model(cfg, tech, device="cpu", ctx=ctx)
    if start is None:
        state, _ = init_train_state(model, tech, 0, OPT, ctx=ctx)
    elif ctx is None:
        state = tree_map(lambda t: t.clone(), start)
        tree_map(lambda t: t.requires_grad_(True), state["params"])
    else:
        state = shard_train_state(start, model, tech, ctx)
    out = {"loss": [], "loss_f": [], "ce": [], "grad_norm": [],
           "collectives": [], "seams": [], "kv": [], "widths": [],
           "mode": ctx.attn_mode if ctx is not None else None}
    step = build_train_step(model, tech, OPT, ctx=ctx)
    timer = Timer()
    if ctx is not None:
        ctx.comm_timer = timer
    lay = DPLayout(model, tech, ctx) if ctx is not None else None
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        if ctx is not None:
            lo, hi = ctx.batch_sharding(batch["tokens"].shape[0])
            batch = {k: v[lo:hi] for k, v in batch.items()}
        n0 = {k: len(timer.records[k]) for k in ("collective", "seam", "kv")}
        with logits_widths(out["widths"]):
            state, met = step(state, batch)
        out["collectives"].append(len(timer.records["collective"])
                                  - n0["collective"])
        out["seams"].append(len(timer.records["seam"]) - n0["seam"])
        out["kv"].append(len(timer.records["kv"]) - n0["kv"])
        out["loss"].append(int(host(met["loss"])))
        out["loss_f"].append(float(met["loss"]))
        out["ce"].append(float(met["ce"]))
        out["grad_norm"].append(float(met["grad_norm"]))
        if i == 0:
            out["state1"] = _whole_bits(state, lay, ctx, model)
    if ctx is not None:
        own = {p: host(t) for p, t in keystr_paths(state)}
        state = logical_train_state(state, lay, ctx, model.device)
        if pieces:
            out["own"] = own
            out["cut"] = cut_by_placement(state, model, ctx)
    out["state"] = {p: host(t) for p, t in keystr_paths(state)}
    return out


def _whole_bits(state, lay, ctx, model) -> dict:
    """The whole (logical) state's bits: gathered from the ranks' pieces
    (every rank's collectives) over a mesh."""
    if ctx is not None:
        state = logical_train_state(state, lay, ctx, model.device)
    return {p: host(t).copy() for p, t in keystr_paths(state)}


def cut_by_placement(whole, model, ctx) -> dict:
    """Each leaf of the whole state ``whole`` cut as the reference's
    placement (``train_state_shardings``) places it on this rank: every
    dim whose spec entry names mesh axes split into the product of their
    sizes, this rank's index over them (the first axis the major).
    Returns the cuts' bits."""
    place = dict(keystr_paths(train_state_shardings(whole, model, ctx)))
    index = {MODEL: ctx.rank, "data": ctx.mesh.data_rank}
    out = {}
    for path, t in keystr_paths(whole):
        for dim, entry in enumerate(place[path].spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            n, idx = 1, 0
            for a in axes:
                n *= ctx.axis_size(a)
                idx = idx * ctx.axis_size(a) + index[a]
            w = t.shape[dim] // n
            t = t.narrow(dim, idx * w, w)
        out[path] = host(t)
    return out


@contextlib.contextmanager
def tp_order(cfg, tp: int, sp: bool = False):
    """One device computing the dense family's forward as ``tp`` model
    ranks do, every op at a rank's shapes: each attention block and FFN
    once a rank on its heads and MLP columns (under sequence parallelism
    each norm on a rank's rows), its row-parallel f32 partials added in
    rank order and rounded once; the loss block's logits a rank's vocab
    slice at a time, the max over the slices, each slice's sum of
    exponentials and label logit added in rank order
    (``models.lm.vocab_parallel_ce``'s arithmetic). Two ranks add as
    gloo's all-reduce adds them."""
    attn, ffn, block_ce = B.attn_apply, B.ffn_apply, LMmod.LM._block_ce
    h_, k_, f_ = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.d_ff // tp

    def cut(w, dim, n, r):
        return w.narrow(dim, r * n, n).contiguous()

    def norm(x, w):
        if not sp:
            return L.rmsnorm(x, w, cfg.norm_eps)
        t = x.shape[1]
        return torch.cat([L.rmsnorm(x[:, r * t // tp:(r + 1) * t // tp], w,
                                    cfg.norm_eps) for r in range(tp)], 1)

    def attn_tp(x, p, c, *, positions, attn_impl="naive", qmm_impl="kernel",
                **kw):
        h = norm(x, p["ln"])
        y = None
        for r in range(tp):
            pr = dict(p)
            for key, n in (("wq", h_), ("wk", k_), ("wv", k_)):
                pr[key] = cut(p[key], 1, n, r)
            for key, n in (("bq", h_), ("bk", k_), ("bv", k_)):
                if key in p:
                    pr[key] = cut(p[key], 0, n, r)
            q, k, v = B._qkv(h, pr, c, positions)
            o = L.attention(q, k, v, mode=attn_impl, causal=True)
            part = L.dense(o, cut(p["wo"], 0, h_, r), 2,
                           out_dtype=torch.float32)
            y = part if y is None else y + part
        return x + y.to(x.dtype), None

    def ffn_tp(x, p, c, qmm_impl="kernel", ctx=None):
        h = norm(x, p["ln"])
        y = None
        for r in range(tp):
            g = L.dense(h, cut(p["w_gate"], 1, f_, r), out_dtype=torch.float32)
            u = L.dense(h, cut(p["w_up"], 1, f_, r), out_dtype=torch.float32)
            part = L.dense(L.silu(g) * u, cut(p["w_down"], 0, f_, r),
                           out_dtype=torch.float32)
            y = part if y is None else y + part
        return x + y.to(x.dtype)

    def block_ce_tp(self, params, xb, lb):
        x = L.rmsnorm(xb, params["final_ln"], cfg.norm_eps)
        v = self.vocab // tp
        logits = [L.dense(x, params["embed"][r * v:(r + 1) * v].T
                          if cfg.tie_embeddings else
                          cut(params["head"], 1, v, r)).float()
                  for r in range(tp)]
        m = torch.stack([lg.amax(-1) for lg in logits]).amax(0)
        s = lab = None
        for r, lg in enumerate(logits):
            idx = lb.long() - r * v
            own = (idx >= 0) & (idx < v)
            got = lg.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
            sr = torch.exp(lg - m[..., None]).sum(-1)
            lr = torch.where(own, got, torch.zeros(()))
            s, lab = (sr, lr) if s is None else (s + sr, lab + lr)
        mask = (lb >= 0).float()
        return ((m + torch.log(s) - lab) * mask).sum(), mask.sum()

    B.attn_apply, B.ffn_apply, LMmod.LM._block_ce = attn_tp, ffn_tp, \
        block_ce_tp
    try:
        yield
    finally:
        B.attn_apply, B.ffn_apply, LMmod.LM._block_ce = attn, ffn, block_ce


def emulate(mesh, arch, label, batches, tp, sp=False):
    """The loss bits of one device's forward from the seed state on the
    first of ``batches`` in the order of sums of ``tp`` model ranks
    (:func:`tp_order`)."""
    cfg = get_config(arch, reduced=True)
    tech = technique(label, 1, sp=sp)
    model = make_model(cfg, tech, device="cpu")
    params = model.init(0)
    b = {k: torch.from_numpy(v.copy()) for k, v in batches[0].items()}
    with torch.no_grad(), tp_order(cfg, tp, sp):
        return int(host(model.loss(params, b)[0]))


def pipe_case(seed: int = 0, layers: int = 4, d: int = 16, n_micro: int = 6,
              mb: int = 8):
    """tests/test_substrate.py's pipeline case: ``layers`` tanh(c @ w)
    layers, w and the microbatches drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((layers, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    return w, x


def _tanh_stage(p, x):
    for wl in p.unbind(0):
        x = torch.tanh(x @ wl)
    return x


def pipeline(mesh, stages: int = 2):
    """The GPipe forward of :func:`pipe_case` over ``stages`` stages on
    this mesh's model axis, its bubble fraction, and the port's
    sequential loop over the same layers (one device)."""
    w, x = pipe_case()
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    fwd = PP.pipeline_forward(mesh, MODEL, _tanh_stage, n_micro=x.shape[0])
    out = fwd(PP.split_stages(wt, stages), xt)
    seq = torch.stack([_tanh_stage(wt, xt[m]) for m in range(x.shape[0])])
    return {"out": host(out), "seq": host(seq),
            "bubble": PP.bubble_fraction(x.shape[0], stages)}


KINDS = {"train": train, "emulate": emulate, "pipeline": pipeline}


def run_all(mesh, plan):
    """Each case of ``plan`` in turn: ``(name, kind, kwargs)``; a kwargs'
    ``oracle`` runs it on one device on global rank 0 alone."""
    out = {}
    for name, kind, kw in plan:
        kw = dict(kw)
        if kw.pop("oracle", False):
            if mesh is not None and (mesh.data_rank, mesh.rank) != (0, 0):
                continue
            out[name] = KINDS[kind](None, **kw)
        else:
            out[name] = KINDS[kind](mesh, **kw)
    return out
