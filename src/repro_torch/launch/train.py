"""Training launcher CLI (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --technique F+R+Z3 --steps 10 --batch 4 --seq 2048

runs on the card; ``--reduced --device cpu`` runs the smoke config on
the CPU through the kernels' plain versions. ``--technique QL+Q8+F+R``
fine-tunes LoRA adapters on an int8 frozen base; ``Q8``/``Q`` train every
weight of an int8/nf4 base with 8-bit moments; the trainable and total
parameter counts are printed first. ``--checkpoint-dir DIR`` saves every
50 steps (and on SIGTERM) and ``--resume auto`` continues from the
latest committed step there.

``--data-parallel N`` trains over a data axis of N ranks
(``launch.mesh.spawn_ranks``; ZeRO stages and offload as the technique
says), ``--dist-backend`` gloo (the CPU, or ranks sharing a card) or
nccl (one card per rank); rank 0's lines are printed after the rank
mapping. ``--model-parallel N`` trains over a model axis of N ranks
(Megatron-style tensor parallelism; ``--sp`` adds sequence
parallelism), alone or beside ``--data-parallel M`` (a 2-D mesh of M x
N ranks under any ZeRO stage), every family but the encoder-decoder one:
the MoE archs (``--arch qwen3-moe-30b-a3b``, ``dbrx-132b``) with their
experts split over the axis where N divides them (expert parallelism,
each rank routing its slice of T at its own capacity), jamba's Mamba-2
layers on their SSD heads, internvl2's front end as on one device; each
rank prints its trainable count. ``--attn-mode`` picks the attention's
split over that axis, the reference's flag of that name: ``head`` (the
heads), ``seq`` (context parallelism: each rank attends with its rows
of T against the k/v of every rank) or ``auto`` (sequence mode where N
does not divide the heads). ``Q``, ``Q8`` and LoRA refuse both axes. MoE archs
(``--arch qwen3-moe-30b-a3b``, ``jamba-v0.1-52b``) train over a data
axis with one micro-batch a rank, routed with the global batch's
statistics, order and capacity, as the reference's GSPMD step routes the
global batch (under expert parallelism on a 2-D mesh, each shard's own).
"""
import argparse
import math
import os
from typing import List

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import SHAPES, ShapeSpec, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.models.params import ParamSpec, tree_paths
from repro_torch.peft.lora import split_trainable
from repro_torch.quant.qtensor import QTensor


def _weights(leaf) -> int:
    if not isinstance(leaf, QTensor):
        return leaf.numel()
    if leaf.data is None:
        return 0
    if leaf.kind == "int8":
        return leaf.data.numel()
    # nf4 packs two codes a byte; ``shape`` is a stacked leaf's per layer
    return (leaf.data.shape[0] if leaf.data.ndim == 2 else 1) * math.prod(
        leaf.shape)


def n_weights(tree) -> int:
    """Weights in a parameter tree; a QTensor holds one code per weight
    (its scales are not counted; the trainable tree's QTensors under
    LoRA hold none)."""
    return sum(_weights(leaf) for _, leaf in tree_paths(
        tree, is_leaf=lambda x: isinstance(x, QTensor)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--technique", default="F+R+Z3")
    ap.add_argument("--shape", default=None, choices=[None] + list(SHAPES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="ranks on the data axis (ZeRO stages and offload "
                         "as --technique says)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis (tensor parallelism; "
                         "expert parallelism on MoE archs)")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism over the model axis")
    ap.add_argument("--attn-mode", default="auto",
                    choices=["auto", "head", "seq"],
                    help="attention over the model axis: split the heads "
                         "(head), the sequence (seq, context parallelism), "
                         "or seq where the axis does not divide the heads "
                         "(auto)")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="the ranks' backend: gloo (the CPU, or ranks "
                         "sharing a card) or nccl (one card per rank); "
                         "required on the card with --data-parallel or "
                         "--model-parallel")
    args = ap.parse_args(argv)
    if args.data_parallel < 1 or args.model_parallel < 1:
        ap.error("--data-parallel and --model-parallel must be >= 1")
    n = args.data_parallel * args.model_parallel
    if n == 1:
        for line in _train(None, args):
            print(line)
        return
    from repro_torch.launch.mesh import spawn_ranks
    cpu = args.device is not None and args.device.startswith("cpu")
    backend = args.dist_backend or ("gloo" if cpu else None)
    if backend is None:
        ap.error("--data-parallel or --model-parallel on the card needs "
                 "--dist-backend: nccl (one card per rank) or gloo (ranks "
                 "sharing a card)")
    # CPU ranks share the host's cores evenly
    threads = max(1, (os.cpu_count() or 1) // n)
    ranks = spawn_ranks(_train, args.model_parallel, data=args.data_parallel,
                        backend=backend, device="cpu" if cpu else None,
                        args=(args,), threads=threads if cpu else None)
    for line in ranks[0]:
        print(line)
    for r, lines in enumerate(ranks[1:], 1):
        print(f"rank {r}: {lines[0]}")


def _train(mesh, args) -> List[str]:
    """Train as the CLI says, alone (``mesh=None``) or as one rank of
    ``mesh``; returns the lines to print (rank 0's are printed)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = (SHAPES[args.shape] if args.shape
             else ShapeSpec("cli", args.seq, args.batch, "train"))
    technique = technique_from_label(args.technique, sp=args.sp,
                                     attn_mode=args.attn_mode)
    trainer = Trainer(cfg, shape, technique,
                      TrainerConfig(steps=args.steps,
                                    checkpoint_dir=args.checkpoint_dir,
                                    resume=args.resume),
                      device=args.device if mesh is None else None,
                      mesh=mesh)
    params = trainer.state["params"]
    out: List[str] = []
    if mesh is None:
        out.append(f"{args.technique}: "
                   f"{n_weights(split_trainable(params)[0])} trainable of "
                   f"{n_weights(params)} parameters")
    else:
        ctx = trainer.ctx
        n = sum(math.prod(s) for s in trainer.layout.shapes.values())
        total = sum(math.prod(ps.shape) for _, ps in tree_paths(
            trainer.model.param_specs(),
            is_leaf=lambda x: isinstance(x, ParamSpec)))
        out.append(f"{args.technique}: {n} trainable on this rank (its "
                   f"model-axis pieces) of {total} parameters, "
                   f"{ctx.dp_size} data-parallel ranks x {ctx.size} "
                   f"model-parallel (attention in {ctx.attn_mode} mode), "
                   f"grad_accum "
                   f"{trainer.technique.grad_accum} a rank")
    if trainer.start_step:
        out.append(f"resumed at step {trainer.start_step}")
    res = trainer.run()
    for h in res["history"]:
        out.append(f"step {h['step']:>6d}  loss {h['loss']:.4f}")
    out.append(f"{res['tokens_per_s']:.0f} tokens/s, "
               f"{res['step_ms']:.1f} ms/step")
    return out


if __name__ == "__main__":
    main()
