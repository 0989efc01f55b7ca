"""Rank body of tests/test_torch_tp_serving.py. The spawned ranks import
this module to unpickle their function, so it imports torch and the port
only, never JAX."""
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.serving.engine import Engine, Request


def _host(t: torch.Tensor):
    """A tensor as numpy, bit for bit (bf16 as its int16 view)."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def serve(mesh, arch, params, prompts, max_new, engine_kw, cfg_kw=None):
    """Serve ``prompts`` on the reduced ``arch`` (with the fields
    ``cfg_kw`` replaced; one device when ``mesh`` is None) and return
    what the tests hold: tokens, counters, the final pools and the shapes
    each rank holds."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **(cfg_kw or {}))
    eng = Engine(cfg, params, mesh=mesh,
                 device="cpu" if mesh is None else None, **engine_kw)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, tokens=list(p), max_new_tokens=max_new))
    eng.run(max_steps=800)
    assert all(r is None for r in eng.running)
    mix = eng.params["blocks"]["pos0"]["mix"]
    return {
        "out": {r.rid: list(r.output) for r in eng.finished},
        "stats": eng.stats(),
        "trace_counts": dict(eng.trace_counts),
        "preemptions": eng.sched.n_preemptions,
        "free": (eng.alloc.n_free, eng.alloc.n_blocks),
        "pool": {k: _host(v) for k, v in eng.kv.pool().items()},
        "ssm": {f"{pos}/{leaf}": _host(a)
                for pos, st in eng._ssm_states.items()
                for leaf, a in st.items()},
        "mix_shapes": {k: tuple(v.shape) for k, v in mix.items()},
        "ffn_shapes": {f"pos{pos}/{k}": tuple(v.shape)
                       for pos, blk in eng.params["blocks"].items()
                       for k, v in blk["ffn"].items()},
    }


def serve_all(mesh, runs):
    """Each run of ``runs`` in turn on one set of ranks."""
    return [serve(mesh, *run) for run in runs]


def fail_on(mesh, rank):
    """Raise on ``rank``; the others hang, to be terminated."""
    if mesh.rank == rank:
        raise ValueError(f"planted failure on rank {rank}")
    time.sleep(600)


def moe_dispatch(mesh, arch, tparams, x_ep, x_dp, cot, mult, coef):
    """The MoE FFN of ``arch``'s first MoE layer on two ranks, from the
    whole bridged tree ``tparams``:

    * expert parallelism: ``moe_apply`` under the serving context (this
      rank's experts) on ``x_ep`` (every rank the whole input), returning
      the output and the loss;
    * a data axis over the same two processes (``make_shard_ctx`` of a
      technique without TP on the mesh seen as ``data`` x 1): this rank's
      rows of ``x_dp`` through ``moe_apply`` with the whole weights,
      returning its rows, the loss and the gradients of ``dp ·
      sum(y · cot) + coef · aux`` (the loss's gradient scaled by ``dp``,
      as ``LM.loss(aux_grad_scale=dp)``) w.r.t. the router and the
      experts, summed over the ranks (f32) and divided by ``dp``: the
      gradients of ``sum(y · cot) + coef · aux`` over the whole batch.

    Inputs are f32 arrays of bf16 values; bf16 results come back as
    their int16 bits."""
    from repro_torch.core.config import technique_from_label
    from repro_torch.models import blocks as B
    from repro_torch.models.lm import LM, _GradScale
    from repro_torch.parallel.sharding import (make_serving_ctx,
                                               make_shard_ctx, shard_params)
    cfg = get_config(arch, reduced=True)
    ctx = make_serving_ctx(cfg, mesh)
    pos = LM(cfg, device="cpu").fkinds.index("moe")

    def layer(tree):
        return {k: v[0] for k, v in tree["blocks"][f"pos{pos}"]["ffn"].items()}

    out = {}
    with torch.no_grad():
        y, aux = B.moe_apply(torch.from_numpy(x_ep).bfloat16(),
                             layer(shard_params(tparams, ctx)), cfg, mult,
                             ctx)
    out["ep"], out["ep_aux"] = _host(y), float(aux)
    out["ep_bytes"] = ctx.exchange_bytes
    m = ctx.size
    data = dataclasses.replace(
        mesh, shape={"data": m, "model": 1}, rank=0,
        ranks=(mesh.ranks[mesh.rank],), group=None, data_rank=mesh.rank,
        data_ranks=mesh.ranks, data_group=mesh.group)
    dctx = make_shard_ctx(cfg, technique_from_label("F+R"), data)
    lo, hi = dctx.batch_sharding(x_dp.shape[0])
    p = {k: v.clone().requires_grad_(True) for k, v in layer(tparams).items()}
    y, aux = B.moe_apply(torch.from_numpy(x_dp[lo:hi]).bfloat16(), p, cfg,
                         mult, dctx)
    obj = m * (y.float() * torch.from_numpy(cot[lo:hi])).sum() + \
        coef * _GradScale.apply(aux, float(m))
    names = ("router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad(obj, [p[k] for k in names])
    out["dp"], out["dp_aux"] = _host(y), float(aux.detach())
    out["dp_grads"] = {k: (dctx.dp_all_reduce(g.float()) / m).numpy()
                       for k, g in zip(names, grads)}
    return out
