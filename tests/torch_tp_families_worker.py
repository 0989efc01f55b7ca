"""Rank body of tests/test_torch_tp_train_families.py. The spawned ranks
import this module to unpickle their function, so it imports torch and
the port only, never JAX.

``run_all(mesh, plan)`` runs every case of ``plan`` in turn on one set
of ranks: a case is ``(name, kind, kwargs)``; each rank returns
``{name: result}``."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.perfscope import Timer
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch.build import make_model
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import keystr_paths, tree_map
from repro_torch.parallel.sharding import make_shard_ctx
from repro_torch.train.step import (DPLayout, build_train_step,
                                    logical_train_state, shard_train_state)

from torch_dp_worker import OPT, host, technique

REGIONS = ("collective", "seam", "kv", "exchange")


def config(arch, cfg_kw=None):
    """The reduced ``arch`` with the fields of ``cfg_kw`` replaced."""
    return dataclasses.replace(get_config(arch, reduced=True),
                               **(cfg_kw or {}))


def to_batch(b):
    """A numpy batch as tensors: token ids as they are, frontend
    embeddings (f32 draws) rounded to bf16, as the reference rounds
    them."""
    return {k: torch.from_numpy(v.copy()).to(torch.bfloat16)
            if v.dtype == np.float32 else torch.from_numpy(v.copy())
            for k, v in b.items()}


def forced_route(routes, flips: list):
    """``models.blocks._route`` that takes the reference's experts where
    a near tie of two gates flipped a choice between XLA's and torch's
    sums: ``routes`` holds every expert array the reference's router
    returned (each call, each shard); each call takes the one of its
    shape that agrees most with its own choice, and where that one
    differs, routes to it with the gates gathered at its experts and
    renormalised and the load-balancing loss recomputed from them. The
    tokens whose experts it changed are counted in ``flips``."""
    orig = B._route

    def forced(h, w, cfg, ctx=None):
        top_w, top_e, aux = (orig(h, w, cfg) if ctx is None else
                             orig(h, w, cfg, ctx))
        e, k = cfg.n_experts, cfg.top_k
        own = top_e.reshape(-1, k)
        cands = [torch.from_numpy(r.reshape(-1, k)).long() for r in routes
                 if r.size == own.numel()]
        want = max(cands, key=lambda c: int((c == own).all(-1).sum()))
        if torch.equal(want, own):
            return top_w, top_e, aux
        flips.append(int((want != own).any(-1).sum()))
        gates = torch.softmax(L.dense(h.float(), w).float(), -1).reshape(
            -1, e)
        tw = gates.gather(-1, want)
        tw = tw / torch.clamp_min(tw.sum(-1, keepdim=True), 1e-9)
        first = (want[:, :1] == torch.arange(e)).float()
        aux = e * (gates.mean(0) * first.mean(0)).sum()
        return tw.reshape(top_w.shape), want.reshape(top_e.shape), aux

    return forced


def train(mesh, arch, label, batches, start, *, sp=False,
          attn_mode="auto", cfg_kw=None, routes=None):
    """Steps of ``label`` on the reduced ``arch`` (``cfg_kw`` replacing
    fields) over ``batches`` (whole global batches as numpy) as this rank
    of ``mesh``, from ``start`` (a whole one-device state: the
    reference's, bridged); on one device where ``mesh`` is None (the
    whole batch, no routing forced). Returns each step's loss, ce, aux and
    grad_norm, the collectives a step by ``ShardCtx.comm_timer`` region,
    the exchange's bytes, the context's attention mode, the tokens whose
    experts ``routes`` forced (:func:`forced_route`), and the whole
    state's bits after the first step (``state1``: every leaf's first
    moment is its gradient's) and after the last (``state``)."""
    cfg = config(arch, cfg_kw)
    tech = technique(label, 1, sp=sp, attn_mode=attn_mode)
    ctx = make_shard_ctx(cfg, tech, mesh)
    model = make_model(cfg, tech, device="cpu", ctx=ctx)
    if mesh is None:
        state = tree_map(lambda t: t.clone(), start)
        tree_map(lambda t: t.requires_grad_(True), state["params"])
    else:
        state = shard_train_state(start, model, tech, ctx)
    lay = DPLayout(model, tech, ctx) if mesh is not None else None
    step = build_train_step(model, tech, OPT, ctx=ctx)
    timer = Timer()
    ctx.comm_timer = timer
    out = {"loss_f": [], "ce": [], "aux": [], "grad_norm": [],
           "exchange_bytes": [], "mode": ctx.attn_mode, "flips": [],
           **{r: [] for r in REGIONS}}
    route = B._route
    try:
        for i, b in enumerate(batches):
            if routes is not None:      # the first step's routing
                B._route = forced_route(routes, out["flips"]) if i == 0 \
                    else route
            batch = to_batch(b)
            lo, hi = ctx.batch_sharding(batch["tokens"].shape[0])
            batch = {k: v[lo:hi] for k, v in batch.items()}
            n0 = {r: len(timer.records[r]) for r in REGIONS}
            x0 = ctx.exchange_bytes
            state, met = step(state, batch)
            for r in REGIONS:
                out[r].append(len(timer.records[r]) - n0[r])
            out["exchange_bytes"].append(ctx.exchange_bytes - x0)
            for key in ("ce", "aux", "grad_norm"):
                out[key].append(float(met[key]))
            out["loss_f"].append(float(met["loss"]))
            if i == 0:
                out["state1"] = _whole_bits(state, lay, ctx, model)
    finally:
        B._route = route
    out["state"] = _whole_bits(state, lay, ctx, model)
    return out


def _whole_bits(state, lay, ctx, model) -> dict:
    """The whole (logical) state's bits, gathered from every rank's
    pieces (every rank's collectives): params and first moments."""
    whole = (state if lay is None else
             logical_train_state(state, lay, ctx, model.device))
    return {p: host(t).copy() for p, t in keystr_paths(whole)
            if p.startswith(("['params']", "['opt']['m']"))}


def autograd(mesh):
    """The exchange's pieces under autograd at this rank: ``all_to_all``
    of a seeded bf16 send and its VJP for a seeded cotangent, against
    the exchange of that cotangent without autograd; ``gather_t`` of the
    rank's slice and ``slice_t`` of the whole, each with its VJP; and
    the split norm (``kernels.ops.rmsnorm_split``) of this rank's half of
    seeded f32 rows, with its ``dx``/``dw``. Returns bits and values."""
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True)
    ctx = make_shard_ctx(cfg, technique("F+R", 1), mesh)
    m, r = ctx.size, ctx.rank
    rng = np.random.default_rng(40 + r)
    send = torch.from_numpy(rng.standard_normal((m, 6, 8)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    cot = torch.from_numpy(rng.standard_normal((m, 6, 8)).astype(
        np.float32)).to(torch.bfloat16)
    recv = ctx.all_to_all(send)
    g_send, = torch.autograd.grad(recv, send, cot)
    with torch.no_grad():
        back = ctx.all_to_all(cot)
    shared = np.random.default_rng(50)          # alike on every rank
    whole = torch.from_numpy(shared.standard_normal((2, 8, 6)).astype(
        np.float32)).to(torch.bfloat16)
    g_whole = torch.from_numpy(shared.standard_normal((2, 8, 6)).astype(
        np.float32)).to(torch.bfloat16)
    lo, hi = ctx.own_rows(8)
    part = whole[:, lo:hi].clone().requires_grad_(True)
    gathered = ctx.gather_t(part, 8)
    g_part, = torch.autograd.grad(gathered, part, g_whole)
    src = whole.clone().requires_grad_(True)
    sliced = ctx.slice_t(src)
    g_rows = torch.from_numpy(rng.standard_normal(tuple(sliced.shape)).astype(
        np.float32)).to(torch.bfloat16)
    g_src, = torch.autograd.grad(sliced, src, g_rows)
    with torch.no_grad():
        every = ctx.gather_t(g_rows, 8)
    x = torch.from_numpy(shared.standard_normal((3, 5, 64)).astype(
        np.float32))
    w = torch.from_numpy(shared.uniform(0.5, 1.5, 64).astype(np.float32))
    dy = torch.from_numpy(shared.standard_normal((3, 5, 64)).astype(
        np.float32))
    c0, c1 = r * 64 // m, (r + 1) * 64 // m
    xr = x[..., c0:c1].clone().requires_grad_(True)
    wr = w[c0:c1].clone().requires_grad_(True)
    y = kops.rmsnorm_split(xr, wr, 64, ctx, 1e-5)
    dx, dw = torch.autograd.grad(y, [xr, wr], dy[..., c0:c1])
    xw, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yw = rn.rmsnorm_plain(xw, ww, 1e-5)
    dxw, dww = torch.autograd.grad(yw, [xw, ww], dy)
    return {"send": host(send), "recv": host(recv), "g_send": host(g_send), "back": host(back),
            "gathered": host(gathered), "whole": host(whole),
            "g_part": host(g_part), "g_whole_rows": host(g_whole[:, lo:hi]),
            "sliced": host(sliced), "g_src": host(g_src),
            "every": host(every),
            "norm": (y.detach().numpy(), yw.detach()[..., c0:c1].numpy()),
            "dx": (dx.numpy(), dxw[..., c0:c1].numpy()),
            "dw": (dw.numpy(), dww[c0:c1].numpy())}


KINDS = {"train": train, "autograd": autograd}


def run_all(mesh, plan):
    """Each case of ``plan`` in turn: ``(name, kind, kwargs)``; a kwargs'
    ``oracle`` runs it on one device, on global rank 0 alone."""
    out = {}
    for name, kind, kw in plan:
        kw = dict(kw)
        if kw.pop("oracle", False):
            if (mesh.data_rank, mesh.rank) == (0, 0):
                out[name] = KINDS[kind](None, **kw)
            continue
        out[name] = KINDS[kind](mesh, **kw)
    return out
