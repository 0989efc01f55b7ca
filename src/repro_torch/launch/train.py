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
"""
import argparse
import math

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import SHAPES, ShapeSpec, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.models.params import tree_paths
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = (SHAPES[args.shape] if args.shape
             else ShapeSpec("cli", args.seq, args.batch, "train"))
    technique = technique_from_label(args.technique)
    trainer = Trainer(cfg, shape, technique,
                      TrainerConfig(steps=args.steps,
                                    checkpoint_dir=args.checkpoint_dir,
                                    resume=args.resume),
                      device=args.device)
    params = trainer.state["params"]
    print(f"{args.technique}: {n_weights(split_trainable(params)[0])} "
          f"trainable of {n_weights(params)} parameters")
    if trainer.start_step:
        print(f"resumed at step {trainer.start_step}")
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:>6d}  loss {h['loss']:.4f}")
    print(f"{out['tokens_per_s']:.0f} tokens/s, {out['step_ms']:.1f} ms/step")


if __name__ == "__main__":
    main()
