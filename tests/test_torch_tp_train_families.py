"""Tensor-parallel training of the MoE, hybrid and vision-language
families on the CPU: qwen3-moe-30b-a3b (expert parallelism, and the
one-device dispatch with the experts cut on their MLP width where the
axis does not divide the experts), jamba-v0.1-52b (the Mamba-2 block's
seams and its split gated norm under autograd, and an MoE FFN) and
internvl2-26b (the vision front end) over a model axis of gloo ranks, in
head mode with sequence parallelism off and on and in sequence mode, and
on the (2 x 2) data x model mesh under ZeRO-3, held against the
reference's own step on a mesh of host devices.

Under expert parallelism each (data, model) shard routes its own rows at
its own capacity and the load-balancing loss is the mean of the shards'
(the reference's ``shard_map`` and ``pmean``), so the one-device step is
not the oracle of the whole loss: the reference's ``build_train_step``
is, run on (1 x 2), (1 x 4) and (2 x 2) meshes of host devices in
subprocesses (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
from its seeded state, which the ranks start from too (bridged), on the
same numpy-seeded batches, compiled without excess precision, its
attention through its Pallas kernels in interpret mode (the port's
``F`` is the flash kernels' plain version). One reference run serves a
mesh's cases: placement changes no math in its GSPMD program. Where a
near tie of two gates flips a choice between XLA's and torch's sums, the
ranks take the reference's experts in the first step
(``torch_tp_families_worker.forced_route``).

Limits, on the first step (as test_torch_dp_train.py holds its MoE
cases to the reference: a later step follows Adam's first, which turns
gradients near 0 into ±lr, and a routing that then flips; the reference
itself moves by 0.014 in step 2's loss between its (1 x 1) and (1 x 4)
meshes on the six-expert variant): test_torch_tp_train.py's grad_norm
(1e-3), first moments (each leaf's gradient: within 2^-5 of its norm)
and params (``_holds``), every leaf of the reference's state compared,
so ``LM.model_summed`` is checked leaf by leaf; the ce within its 1e-5
relative of the
port's one-device step from the same state (no assignment drops at
smoke size: the MoE output is the one-device output); the step-1 loss,
ce and load-balancing loss within 1e-4 relative of the reference's: the
port's one-device step sits 0 (qwen3-moe), 1.2e-5 (jamba's cut) and
6.7e-5 (internvl2) from the reference's one-device step on these
batches, whatever the mesh. The autograd pieces are held directly: the
exchange's VJP is the reverse exchange and ``gather_t`` and the t-slice
transpose each other, bit for bit; the split gated norm's ``dx``/``dw``
at tp 2 equal the whole norm's within 2e-5."""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.config import technique_from_label as jtech
from repro.models.lm import LM as JLM
from repro.train import optimizer as jopt
from repro.train.step import init_train_state as jinit
from repro_torch.bridge import train_state_from_jax
from repro_torch.configs import get_config
from repro_torch.core.config import technique_from_label
from repro_torch.launch import train as train_cli
from repro_torch.launch.build import build_train
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.params import keystr_paths, tree_map

import torch_tp_families_worker as worker
from test_torch_tp_train import _cos, _float

MOE, JAMBA, VLM = "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "internvl2-26b"
DBRX = "dbrx-132b"
# jamba cut to two layers, as chip_smoke phase 32 cuts it: an attention
# layer with its dense FFN and a Mamba-2 layer with the MoE FFN
JAMBA_CUT = dict(n_layers=2, attn_period=2, attn_offset=0, moe_every=2,
                 moe_offset=1)
SIX = dict(n_experts=6)        # 4 ranks do not divide 6 experts: no EP
B, T, STEPS = 4, 32, 2
CE_RTOL = 1e-5                 # against the port's one-device step
REF_RTOL = 1e-4                # against the reference's (see above)
NORM_RTOL = 1e-3
MOMENT_REL = 2.0 ** -5
GRAD_RTOL = 2e-5               # the split norm's dx, dw


def _batches(cfg, seed: int = 1):
    """STEPS numpy-seeded global batches (a vlm's with ``frontend_len``
    patch embeddings and T - F tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b, n = {}, T
        if cfg.family == "vlm":
            n = T - cfg.frontend_len
            b["frontend_embeds"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, n), dtype=np.int32)
        b["labels"] = rng.integers(0, cfg.vocab_size, (B, n), dtype=np.int32)
        out.append(b)
    return out


ARCHS = {"moe": (MOE, {}), "jamba": (JAMBA, JAMBA_CUT), "vlm": (VLM, {}),
         "six": (MOE, SIX), "dbrx": (DBRX, {})}
# each mesh's reference run: (arch key, (data, model), label, sp)
REFS = {"tp2/moe": ("moe", (1, 2), "F+R", False),
        "tp2/jamba": ("jamba", (1, 2), "F+R", False),
        "tp2/vlm": ("vlm", (1, 2), "F+R", False),
        "tp2/dbrx": ("dbrx", (1, 2), "F+R", False),
        "tp4/six": ("six", (1, 4), "F+R", False),
        "mesh22/moe": ("moe", (2, 2), "F+R+Z3", True)}
# the port's cases: (mesh, name, label, sp, attn_mode)
CASES = [("tp2", "moe/head", "F+R", False, "head"),
         ("tp2", "moe/head+sp", "F+R", True, "head"),
         ("tp2", "moe/seq", "F+R", False, "seq"),
         ("tp2", "jamba/head", "F+R", False, "head"),
         ("tp2", "jamba/head+sp", "F+R", True, "head"),
         ("tp2", "jamba/seq", "F+R", False, "seq"),
         ("tp2", "vlm/head", "F+R", False, "head"),
         ("tp2", "vlm/head+sp", "F+R", True, "head"),
         ("tp2", "dbrx/head", "F+R", False, "head"),
         ("tp4", "six/head", "F+R", False, "head"),
         ("tp4", "six/head+sp", "F+R", True, "head"),
         ("mesh22", "moe/Z3+sp", "F+R+Z3", True, "head")]
MESHES = {"tp2": (1, 2), "tp4": (1, 4), "mesh22": (2, 2)}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread, as in the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference's step on a mesh of host devices, each case's metrics,
# its state after the first step and the experts its router returned
_REF_STEP = """
import dataclasses, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.config import technique_from_label
from repro.models import blocks as RB
from repro.models.lm import LM
from repro.models.params import tree_paths
from repro.parallel.sharding import make_shard_ctx
from repro.train import optimizer as opt
from repro.train.step import (build_train_step, init_train_state,
                              train_state_shardings)
cases = pickle.load(open(sys.argv[1], "rb"))
out, orig = {}, RB._route
for name, c in cases.items():
    routes = []
    def recorded(h, w, cfg):
        res = orig(h, w, cfg)
        jax.debug.callback(lambda e: routes.append(np.asarray(e)), res[1])
        return res
    RB._route = recorded
    cfg = dataclasses.replace(get_config(c["arch"], reduced=True),
                              **c["cfg_kw"])
    tech = dataclasses.replace(technique_from_label(c["label"]),
                               sp=c["sp"])
    data, model = c["mesh"]
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    ctx = make_shard_ctx(cfg, tech, mesh)
    jm = LM(cfg, attn_impl="pallas", remat=tech.remat, ctx=ctx)
    ocfg = opt.AdamWConfig(lr=5e-3, warmup=0)
    state, _ = init_train_state(jm, tech, jax.random.PRNGKey(0), ocfg)
    sh = train_state_shardings(state, jm, ctx)
    rows = NamedSharding(mesh, P("data"))
    def place(b):
        return {k: jax.device_put(jnp.asarray(
            v, jnp.bfloat16 if v.dtype == np.float32 else None), rows)
            for k, v in b.items()}
    step = jax.jit(build_train_step(jm, tech, ctx, ocfg)).lower(
        jax.device_put(state, sh), place(c["batches"][0])).compile(
        compiler_options={"xla_allow_excess_precision": False})
    res = {"metrics": []}
    for i, b in enumerate(c["batches"]):
        state, m = step(jax.device_put(state, sh), place(b))
        res["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            st = jax.device_get(state)
            res["state1"] = {
                pre + p: np.asarray(v, np.float32)
                for pre, tree in (("['params']", st["params"]),
                                  ("['opt']['m']", st["opt"]["m"]))
                for p, v in tree_paths(tree)}
            jax.effects_barrier()
            res["routes"] = list(routes)
    out[name] = res
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference(cases: dict) -> dict:
    """The reference's runs of ``cases`` in a subprocess with four host
    devices."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        subprocess.run([sys.executable, "-c", _REF_STEP, src, dst], env=env,
                       check=True, capture_output=True, timeout=600)
        with open(dst, "rb") as f:
            return pickle.load(f)


def _start(key: str, label: str):
    """The reference's seeded one-device state of ``key``'s config, as
    the port's whole state (host tensors)."""
    arch, kw = ARCHS[key]
    cfg = dataclasses.replace(ref_config(arch, reduced=True), **kw)
    state, _ = jinit(JLM(cfg), jtech(label), jax.random.PRNGKey(0),
                     jopt.AdamWConfig(lr=5e-3, warmup=0))
    return tree_map(lambda t: t.detach(), train_state_from_jax(
        jax.device_get(state), "cpu"))


@pytest.fixture(scope="module")
def runs():
    """The reference's runs (two subprocesses) and, as their routes come
    in, each mesh's ranks (from threads of this process). Returns
    ``({mesh: each rank's results}, {reference run: its results})``."""
    cfgs = {k: worker.config(a, kw) for k, (a, kw) in ARCHS.items()}
    batches = {k: _batches(c) for k, c in cfgs.items()}
    ref_cases = {name: dict(arch=ARCHS[k][0], cfg_kw=ARCHS[k][1],
                            mesh=mesh, label=label, sp=sp,
                            batches=batches[k])
                 for name, (k, mesh, label, sp) in REFS.items()}
    names = sorted(ref_cases)
    with ThreadPoolExecutor(4) as ex:
        halves = [ex.submit(_reference, {n: ref_cases[n] for n in part})
                  for part in (names[::2], names[1::2])]
        starts = {(k, lab): _start(k, lab) for k, _, lab, _ in REFS.values()}
        ref = {}
        for h in halves:
            ref.update(h.result())
        plans = {m: [] for m in MESHES}
        plans["tp2"].append(("autograd", "autograd", {}))
        for mesh, name, label, sp, mode in CASES:
            key = name.split("/")[0]
            arch, kw = ARCHS[key]
            r = ref[f"{mesh}/{key}"]
            common = dict(arch=arch, label=label, batches=batches[key],
                          start=starts[(key, label)], cfg_kw=kw)
            if not any(n == f"{key}/oracle" for n, _, _ in plans[mesh]):
                plans[mesh].append((f"{key}/oracle", "train",
                                    dict(oracle=True, **common)))
            plans[mesh].append((name, "train", dict(
                sp=sp, attn_mode=mode, routes=r["routes"] if
                cfgs[key].n_experts else None, **common)))
        futures = {m: ex.submit(spawn_ranks, worker.run_all, MESHES[m][1],
                                data=MESHES[m][0], backend="gloo",
                                device="cpu", args=(plans[m],), threads=1)
                   for m in MESHES}
        return {m: f.result() for m, f in futures.items()}, ref, starts


def _holds_ref(got, ref, start, what):
    """``got`` (rank 0 of a TP run) against the reference's run ``ref``
    on the same mesh from the same ``start``: test_torch_tp_train's
    ``_holds`` on every leaf of the reference's state after step 1, with
    its grad_norm limit and REF_RTOL on the step-1 loss, ce and
    load-balancing loss; the later steps' losses finite."""
    m = ref["metrics"]
    for key, ours in (("loss", "loss_f"), ("ce", "ce"), ("aux", "aux")):
        np.testing.assert_allclose(got[ours][0], m[0][key], rtol=REF_RTOL,
                                   err_msg=f"{what} {key}")
    np.testing.assert_allclose(got["grad_norm"][0], m[0]["grad_norm"],
                               rtol=NORM_RTOL, err_msg=what)
    assert np.isfinite(got["loss_f"]).all(), what
    want = ref["state1"]
    assert set(want) == set(got["state1"]), what
    for p, wf in want.items():
        g = _float(got["state1"][p])
        if p.startswith("['opt']['m']"):
            assert np.linalg.norm(g - wf) <= MOMENT_REL * np.linalg.norm(
                wf), (what, p, np.linalg.norm(g - wf) / np.linalg.norm(wf))
            continue
        base = start[p].float().numpy()
        upd, d = wf - base, g - base
        if not upd.any():
            assert np.array_equal(g, wf), (what, p)
            continue
        mp = p.replace("['params']", "['opt']['m']", 1)
        gm, wm = _float(got["state1"][mp]), want[mp]
        flip = np.sign(d) != np.sign(upd)
        if flip.any():
            assert np.abs(wm[flip]).max() <= np.abs(gm - wm).max(), (what, p)
        keep = ~flip
        assert np.linalg.norm((g - wf)[keep]) < 0.5 * np.linalg.norm(
            upd[keep]), (what, p)
        assert _cos(d[keep], upd[keep]) >= 0.9, (what, p)


def _start_bits(start) -> dict:
    """The start state's params, keyed as the runs' states."""
    return {p: t for p, t in keystr_paths(start)
            if p.startswith("['params']")}


@pytest.mark.parametrize("mesh,case,label,sp,mode", CASES,
                         ids=[f"{m}-{c}" for m, c, *_ in CASES])
def test_tp_step_holds_to_the_reference_step(runs, mesh, case, label, sp,
                                             mode):
    """Each TP run against the reference's step on the same mesh (every
    leaf's gradient and update) and its ce against the port's one-device
    step; every rank holds the same whole state and issues as many
    collectives of each kind, in the attention mode asked for; few
    tokens, if any, are routed to the reference's experts by force."""
    ranks, ref, starts = runs
    out = ranks[mesh]
    key = case.split("/")[0]
    got = out[0][case]
    want = out[0][f"{key}/oracle"]
    assert got["mode"] == mode, case
    for r, o in enumerate(out):
        for p in got["state"]:
            assert np.array_equal(o[case]["state"][p], got["state"][p]), \
                (case, r, p)
        for region in worker.REGIONS:
            assert o[case][region] == got[region], (case, r, region)
        assert o[case]["exchange_bytes"] == got["exchange_bytes"], (case, r)
    np.testing.assert_allclose(got["ce"][0], want["ce"][0], rtol=CE_RTOL,
                               err_msg=case)
    cfg = worker.config(*ARCHS[key])
    n_moe = cfg.ffn_kinds().count("moe")
    flips = sum(sum(o[case]["flips"]) for o in out)
    assert flips <= 0.01 * B * T * n_moe, (case, flips)
    _holds_ref(got, ref[f"{mesh}/{key}"], _start_bits(starts[(key, label)]),
               case)


@pytest.mark.parametrize("mesh,case,label,sp,mode",
                         [c for c in CASES if c[1].split("/")[0] in
                          ("moe", "jamba", "dbrx")],
                         ids=[f"{m}-{c}" for m, c, *_ in CASES
                              if c.split("/")[0] in ("moe", "jamba", "dbrx")])
def test_exchanges_a_step(runs, mesh, case, label, sp, mode):
    """Under expert parallelism (F+R) each MoE layer exchanges its rows
    twice in the forward, again in the recomputation and twice backward;
    without sp it also gathers its t-slices (forward only: the
    recomputation stops before its last tensor) and, backward, the
    t-slice's cotangents. The exchange carries ``size`` times the
    dispatch buffer each way."""
    got = runs[0][mesh][0][case]
    n_moe = worker.config(*ARCHS[case.split("/")[0]]).ffn_kinds().count(
        "moe")
    per_layer = 6 if sp else 8
    assert got["exchange"] == [n_moe * per_layer] * STEPS, got["exchange"]
    assert all(b > 0 for b in got["exchange_bytes"])


def test_exchange_vjp_is_the_reverse_exchange(runs):
    """``ShardCtx.all_to_all`` under autograd: block i of what rank r
    received is block r of what rank i sent, and its VJP of a cotangent
    is the exchange of that cotangent without autograd, bit for bit."""
    out = runs[0]["tp2"]
    for r, o in enumerate(out):
        got = o["autograd"]
        assert np.array_equal(got["g_send"], got["back"]), r
        for i, other in enumerate(out):
            assert np.array_equal(got["recv"][i],
                                  other["autograd"]["send"][r]), (r, i)


def test_gather_t_and_slice_t_transpose_each_other(runs):
    """``gather_t`` of the ranks' slices is the whole, bit for bit, and
    its VJP the rank's rows of a cotangent every rank holds alike;
    ``slice_t``'s VJP is the gather of every rank's slice of the
    cotangent, which is ``gather_t`` of those slices."""
    out = runs[0]["tp2"]
    for r, o in enumerate(out):
        got = o["autograd"]
        assert np.array_equal(got["gathered"], got["whole"]), r
        assert np.array_equal(got["g_part"], got["g_whole_rows"]), r
        assert np.array_equal(got["g_src"], got["every"]), r
        assert np.array_equal(got["every"], out[0]["autograd"]["every"]), r


def test_split_norm_backward_is_the_whole_norms(runs):
    """The split gated norm at tp 2 (``kernels.ops.rmsnorm_split``: each
    rank's half of 64 channels, the row statistics summed over the axis)
    against the whole norm on one device: output, dx and dw within 2e-5
    in f32."""
    for r, o in enumerate(runs[0]["tp2"]):
        got = o["autograd"]
        for key in ("norm", "dx", "dw"):
            a, b = got[key]
            np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_RTOL,
                                       err_msg=f"{key} rank {r}")


def _stand_in(data, model):
    from types import SimpleNamespace
    return SimpleNamespace(shape={"data": data, "model": model},
                           axis_names=("data", "model"), rank=0, data_rank=0,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("arch,label,mesh,item", [
    ("seamless-m4t-large-v2", "F+R", (1, 2), "7.10"),
    (MOE, "L+F+R", (1, 2), "7.11"),
    (JAMBA, "Q8+F+R", (2, 2), "7.11"),
    (MOE, "F+R+Z3:accum2", (2, 2), "7.9"),
])
def test_what_a_model_axis_still_refuses(arch, label, mesh, item):
    """The encoder-decoder family, quantized full training and LoRA under
    a model axis, and MoE with ``grad_accum > 1`` over a data axis,
    raise naming their ROADMAP items."""
    label, _, accum = label.partition(":accum")
    tech = dataclasses.replace(technique_from_label(label),
                               grad_accum=int(accum or 1))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        build_train(get_config(arch, reduced=True), tech, device="cpu",
                    mesh=_stand_in(*mesh))


def test_cli_model_parallel_moe_runs_on_the_cpu(capsys):
    """``--model-parallel 2 --arch qwen3-moe-30b-a3b``: the rank mapping,
    then rank 0's step lines."""
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "32", "--technique", "F+R",
                    "--model-parallel", "2", "--arch", MOE,
                    "--dist-backend", "gloo"])
    out = capsys.readouterr().out
    assert "[mesh] 2 ranks (1 data x 2 model), backend gloo" in out
    assert "2 model-parallel (attention in head mode)" in out
    assert "step      2  loss" in out and "tokens/s" in out
