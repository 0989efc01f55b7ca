"""Training the ssm, moe and hybrid families through the port's
``Trainer`` and train step on the CPU, at smoke size: the loss falls on a
fixed batch (tests/test_system.py's cases) and every technique row the
one-device technique rows run (tests/test_torch_train_families.py holds
the losses and gradients against the reference)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as port_config
from repro_torch.core.config import ShapeSpec, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.launch.build import make_model
from repro_torch.models.params import tree_paths
from repro_torch.train import optimizer as topt
from repro_torch.train.step import build_train_step, init_train_state

from test_torch_train import keep_sigterm  # noqa: F401  (fixture)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_loss_decreases_over_steps(arch):
    """Mirrors tests/test_system.py::test_loss_decreases_over_steps (its
    granite and mamba2 cases)."""
    cfg = port_config(arch, reduced=True)
    tech = technique_from_label("Naive")
    model = make_model(cfg, tech, device="cpu")
    opt = topt.AdamWConfig(lr=5e-3, warmup=0, weight_decay=0.0)
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    losses = []
    for _ in range(12):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen3-moe-30b-a3b",
                                  "dbrx-132b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("label", ["Naive", "F+R+Z3"])
def test_trainer_trains_the_family(arch, label, keep_sigterm):  # noqa: F811
    """``Trainer`` on the CPU, one step: its loss, CE, load-balancing loss
    and gradient norm finite, the aux positive exactly where the arch has
    MoE layers, and every (non-empty) leaf updated (at lr 5e-3: an
    update under half a bf16 ulp leaves a norm weight at 1.0)."""
    cfg = port_config(arch, reduced=True)
    tr = Trainer(cfg, ShapeSpec("cli", 32, 2, "train"),
                 technique_from_label(label),
                 TrainerConfig(steps=1, log_every=1),
                 topt.AdamWConfig(lr=5e-3, warmup=0), device="cpu")
    before = {p: t.detach().clone()
              for p, t in tree_paths(tr.state["params"])}
    out = tr.run()
    assert out["final_step"] == 1
    for h in out["history"]:
        assert all(np.isfinite(h[k]) for k in ("loss", "ce", "aux",
                                               "grad_norm"))
        assert (h["aux"] > 0) == cfg.is_moe
        assert h["loss"] == pytest.approx(
            h["ce"] + 0.01 * h["aux"] / cfg.n_layers, rel=1e-6)
    still = [p for p, t in tree_paths(tr.state["params"])
             if t.numel() and torch.equal(t.detach(), before[p])]
    assert not still, still
    assert tr.model.ssd_impl == "ref"
