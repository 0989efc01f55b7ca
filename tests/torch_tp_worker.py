"""Rank body of tests/test_torch_tp_serving.py. The spawned ranks import
this module to unpickle their function, so it imports torch and the port
only, never JAX."""
import time

import torch

from repro_torch.configs import get_config
from repro_torch.serving.engine import Engine, Request


def _host(t: torch.Tensor):
    """A tensor as numpy, bit for bit (bf16 as its int16 view)."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def serve(mesh, arch, params, prompts, max_new, engine_kw):
    """Serve ``prompts`` on the reduced ``arch`` (one device when
    ``mesh`` is None) and return what the tests hold: tokens, counters,
    the final pools and the shapes each rank holds."""
    cfg = get_config(arch, reduced=True)
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
    }


def serve_all(mesh, runs):
    """Each run of ``runs`` in turn on one set of ranks."""
    return [serve(mesh, *run) for run in runs]


def fail_on(mesh, rank):
    """Raise on ``rank``; the others hang, to be terminated."""
    if mesh.rank == rank:
        raise ValueError(f"planted failure on rank {rank}")
    time.sleep(600)
