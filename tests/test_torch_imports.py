"""The port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports ``jax`` or the JAX package, and its entry
points refuse to run without a card unless asked for the CPU."""
import ast
import signal
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)
    port = REPO / "src" / "repro_torch"
    for module in ("quant/qtensor.py", "peft/lora.py",
                   "kernels/quant_matmul.py", "kernels/rmsnorm.py",
                   "serving/speculate.py", "serving/graphs.py",
                   "configs/llama2_7b.py", "configs/llama2_13b.py",
                   "configs/llama2_70b.py"):
        assert port / module in PORT_FILES, module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(REPO)} imports {mod}")


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    params = LM(cfg, device="cpu").init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    eng = Engine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"
    ssm = get_config("mamba2-130m", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(ssm, LM(ssm, device="cpu").init(0))


def test_training_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(signal, "signal", lambda *a: None)  # keep SIGTERM
    from repro_torch.configs import get_config
    from repro_torch.core.config import ShapeSpec, technique_from_label
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.launch import train as train_cli
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    shape = ShapeSpec("cli", 16, 2, "train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, shape, technique_from_label("F+R"),
                TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, shape, technique_from_label("QL+Q8+F+R"),
                TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--reduced", "--steps", "1", "--batch", "2",
                        "--seq", "16"])
    tr = Trainer(cfg, shape, technique_from_label("F+R"),
                 TrainerConfig(steps=1), device="cpu")
    assert tr.device.type == "cpu"
