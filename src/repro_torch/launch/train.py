"""Training launcher CLI (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --technique F+R+Z3 --steps 10 --batch 4 --seq 2048

runs on the card; ``--reduced --device cpu`` runs the smoke config on
the CPU through the kernels' plain versions. ``--technique QL+Q8+F+R``
fine-tunes LoRA adapters on an int8 frozen base; the trainable and total
parameter counts are printed first.
"""
import argparse

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import SHAPES, ShapeSpec, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.models.params import tree_paths
from repro_torch.peft.lora import split_trainable
from repro_torch.quant.qtensor import QTensor


def n_weights(tree) -> int:
    """Weights in a parameter tree; an int8 QTensor holds one code per
    weight (its scales are not counted; the trainable tree's QTensors
    hold none)."""
    return sum((0 if leaf.data is None else leaf.data.numel())
               if isinstance(leaf, QTensor) else leaf.numel()
               for _, leaf in tree_paths(tree, is_leaf=lambda x: isinstance(
                   x, QTensor)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--technique", default="F+R+Z3")
    ap.add_argument("--shape", default=None, choices=[None] + list(SHAPES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = (SHAPES[args.shape] if args.shape
             else ShapeSpec("cli", args.seq, args.batch, "train"))
    technique = technique_from_label(args.technique)
    trainer = Trainer(cfg, shape, technique, TrainerConfig(steps=args.steps),
                      device=args.device)
    params = trainer.state["params"]
    print(f"{args.technique}: {n_weights(split_trainable(params)[0])} "
          f"trainable of {n_weights(params)} parameters")
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:>6d}  loss {h['loss']:.4f}")
    print(f"{out['tokens_per_s']:.0f} tokens/s, {out['step_ms']:.1f} ms/step")


if __name__ == "__main__":
    main()
