"""Rank body of tests/test_torch_dp_train.py. The spawned ranks import
this module to unpickle their function, so it imports torch and the port
only, never JAX.

``run_all(mesh, plan)`` runs every case of ``plan`` in turn on one set
of ranks (``mesh`` None: in this process, on one device). A case is
``(name, kind, kwargs)``; each rank returns ``{name: result}``. Oracle
cases (the one-device step) run on rank 0 alone, under the ranks'
thread setting."""
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import ShapeSpec, technique_from_label
from repro_torch.core.perfscope import Timer
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch.build import make_model
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import keystr_paths, tree_map
from repro_torch.parallel import compression as C
from repro_torch.parallel import zero as Z
from repro_torch.parallel.sharding import make_shard_ctx
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import (DPLayout, build_train_step,
                                    init_train_state, logical_train_state,
                                    shard_train_state)

OPT = AdamWConfig(lr=5e-3, warmup=0)


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as its int16 view, f32 as int32)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype == torch.float32:
        t = t.view(torch.int32)
    return t.numpy()


def technique(label: str, accum: int, **kw):
    """A label with ``:once`` for ``zero3_gather_once``."""
    once = label.endswith(":once")
    return dataclasses.replace(
        technique_from_label(label.removesuffix(":once")), grad_accum=accum,
        zero3_gather_once=once, **kw)


def forced_route(routes, rows: slice):
    """``models.blocks._route`` that takes the reference's experts:
    ``routes`` holds each MoE layer's (tokens, k) experts on the global
    batch; each call takes, of the layer route that agrees most with its
    own choice, the token ``rows`` this call routes (a near tie of the
    k-th and (k+1)-th gates flips a choice between XLA's and torch's
    sums), with the gates gathered at those experts and renormalised and
    the load-balancing loss recomputed from them, over a data axis with
    the global statistics (every call, so every rank makes the same
    collectives)."""
    orig = B._route

    def forced(h, w, cfg, ctx=None):
        top_w, top_e, _ = (orig(h, w, cfg) if ctx is None else
                           orig(h, w, cfg, ctx))
        e, k = cfg.n_experts, cfg.top_k
        own = top_e.reshape(-1, k)
        want = max((torch.from_numpy(r.reshape(-1, k)[rows]).long()
                    for r in routes),
                   key=lambda c: int((c == own).all(-1).sum()))
        gates = torch.softmax(L.dense(h.float(), w).float(), -1).reshape(
            -1, e)
        tw = gates.gather(-1, want)
        tw = tw / torch.clamp_min(tw.sum(-1, keepdim=True), 1e-9)
        first = (want[:, :1] == torch.arange(e)).float()
        local = torch.cat([gates.sum(0), first.sum(0),
                           gates.new_full((1,), gates.shape[0])])
        if ctx is not None and ctx.dp_size > 1:
            total = ctx.dp_all_reduce(local.detach().clone())
            local = total + (local - local.detach())
        me, ce = local[:e] / local[-1], local[e:2 * e] / local[-1]
        return (tw.reshape(top_w.shape), want.reshape(top_e.shape),
                e * (me * ce).sum())

    return forced


def train(mesh, arch, label, batches, *, accum=1, start=None, opt=OPT,
          count=False, routes=None, cfg_kw=None, **kw):
    """Steps of ``label`` on the reduced ``arch`` over ``batches`` (whole
    global batches as numpy), one device when ``mesh`` is None (the
    whole batch in ``accum`` micro-batches) or this rank's rows. The
    state starts from the seed, or from ``start`` (a whole one-device
    state). Returns each step's loss bits and float, ``grad_norm``,
    ``aux``, the whole final state's bits, and with ``count`` the collectives of each
    step (by ``ShardCtx.comm_timer``). With ``routes`` (one global
    batch's, each MoE layer's experts) the MoE layers route as the
    reference did (:func:`forced_route`). ``cfg_kw`` replaces fields of
    the reduced config."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **(cfg_kw or {}))
    tech = technique(label, accum, **kw)
    ctx = make_shard_ctx(cfg, tech, mesh) if mesh is not None else None
    model = make_model(cfg, tech, device="cpu", ctx=ctx)
    if start is None:
        state, _ = init_train_state(model, tech, 0, opt, ctx=ctx)
    elif ctx is None:
        state = tree_map(lambda t: t.clone(), start)
        tree_map(lambda t: t.requires_grad_(True), state["params"])
    else:
        state = shard_train_state(start, model, tech, ctx)
    step = build_train_step(model, tech, opt, ctx=ctx)
    timer = Timer()
    if ctx is not None and count:
        ctx.comm_timer = timer
    out = {"loss": [], "loss_f": [], "grad_norm": [], "aux": [],
           "collectives": []}
    route = B._route
    if routes is not None:
        rows = batches[0]["tokens"].shape[0]
        lo, hi = (0, rows) if ctx is None else ctx.batch_sharding(rows)
        t = batches[0]["tokens"].shape[1]
        B._route = forced_route(routes, slice(lo * t, hi * t))
    try:
        for b in batches:
            batch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
            if ctx is not None:
                lo, hi = ctx.batch_sharding(batch["tokens"].shape[0])
                batch = {k: v[lo:hi] for k, v in batch.items()}
            n0 = len(timer.records["collective"])
            state, met = step(state, batch)
            out["collectives"].append(len(timer.records["collective"]) - n0)
            out["loss"].append(int(host(met["loss"])))
            out["loss_f"].append(float(met["loss"]))
            out["grad_norm"].append(float(met["grad_norm"]))
            out["aux"].append(float(met["aux"]))
    finally:
        B._route = route
    if ctx is not None:
        state = logical_train_state(state, DPLayout(model, tech, ctx), ctx,
                                    model.device)
    whole = {p: host(t) for p, t in keystr_paths(state)}
    out["state"] = whole
    out["hash"] = hashlib.sha1(b"".join(
        whole[p].tobytes() for p in sorted(whole))).hexdigest()
    return out


def psum(mesh, n):
    """``compressed_psum`` of a seeded gradient of ``n`` values a rank
    (each rank its own seed), from a seeded error carry; returns this
    rank's codes, scales, the sum and the new carry."""
    ctx = make_shard_ctx(get_config("qwen1.5-0.5b", reduced=True),
                         technique_from_label("Naive"), mesh)
    rng = np.random.default_rng(100 + ctx.dp_rank)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    err = torch.from_numpy((rng.standard_normal(n) * 1e-3).astype(
        np.float32))
    q, s, _ = C.compress_grad(g, err)
    total, new_err = C.compressed_psum(ctx, g, err)
    return {"q": q.numpy(), "s": s.numpy(), "sum": total.numpy(),
            "err": new_err.numpy()}


def save(mesh, arch, label, steps, directory):
    """``Trainer`` over the ranks, checkpointing the last step to
    ``directory``."""
    cfg = get_config(arch, reduced=True)
    tr = Trainer(cfg, ShapeSpec("cli", 32, 4, "train"), technique(label, 1),
                 TrainerConfig(steps=steps, log_every=1,
                               checkpoint_every=steps,
                               checkpoint_dir=directory,
                               async_checkpoint=False), OPT, mesh=mesh)
    return tr.run()["history"]


def special_leaves():
    """Whole leaves full of values an f32 sum would not carry bit for
    bit (-0.0, NaN payloads, infinities, subnormals), with the cut each
    is gathered along: f32 rows, and bf16 columns whose pieces share
    int32 words (three columns of two bytes a rank)."""
    f = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1.5, -2.25,
                  3e38, -7e-3], np.float32)
    f = np.tile(f, (6, 1))
    fb = f.view(np.int32).copy()
    fb[1, 3] = 0x7FC00123                      # a NaN with a payload
    fb[4, 0] = np.array([0xFFC00456], np.uint32).view(np.int32)[0]  # -NaN
    b = np.array([[0x0000, 0x8000, 0x7FC1, 0xFFC3, 0x0001, 0x8001],
                  [0x3F80, 0xBF80, 0x7F80, 0xFF80, 0x4049, 0xC049],
                  [0x1234, 0x8765, 0x7F81, 0x0080, 0x8080, 0x7F7F]],
                 np.uint16).view(np.int16)
    return [(torch.from_numpy(fb).view(torch.float32), 0),
            (torch.from_numpy(b.copy()).view(torch.bfloat16), 1)]


def gather_bits(mesh):
    """Each rank's piece of :func:`special_leaves`, gathered by
    ``parallel.zero.gather_leaf``; returns the gathered bits."""
    ctx = make_shard_ctx(get_config("qwen1.5-0.5b", reduced=True),
                         technique_from_label("Z3"), mesh)
    out = []
    for whole, dim in special_leaves():
        cut = Z.Cut(dim, ctx.dp_size, ctx.dp_rank)
        out.append(host(Z.gather_leaf(ctx, Z.take(whole, cut),
                                      tuple(whole.shape), cut)))
    return out


KINDS = {"train": train, "psum": psum, "save": save, "gather": gather_bits}


def run_all(mesh, plan):
    """Each case of ``plan`` in turn: ``(name, kind, kwargs)``; a kwargs'
    ``oracle`` runs it on one device on rank 0 alone."""
    out = {}
    for name, kind, kw in plan:
        kw = dict(kw)
        if kw.pop("oracle", False):
            if mesh is not None and mesh.data_rank != 0:
                continue
            out[name] = KINDS[kind](None, **kw)
        else:
            out[name] = KINDS[kind](mesh, **kw)
    return out
