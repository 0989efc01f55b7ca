"""The port's checkpointing, resume and prefetching against the JAX
package's: the manager's cases of tests/test_substrate.py, the on-disk
layout (manifest and leaf files byte for byte) of a train state bridged
from the reference, each manager reading the other's checkpoints
bitwise, a resumed ``Trainer`` bitwise equal to an uninterrupted one,
the SIGTERM emergency save, the ``Prefetcher`` and the train CLI's
``--checkpoint-dir``/``--resume``."""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config
from repro.core.config import technique_from_label as jtech
from repro.models.lm import LM as JLM
from repro.train import optimizer as jopt
from repro.train.step import init_train_state as jinit
from repro_torch.bridge import from_jax_numpy, train_state_from_jax
from repro_torch.checkpoint.manager import COMMIT_MARKER, CheckpointManager
from repro_torch.configs import get_config as port_config
from repro_torch.core.config import ShapeSpec, technique_from_label
from repro_torch.core.trainer import Trainer, TrainerConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models.params import tree_paths
from repro_torch.train import optimizer as topt

from test_torch_train import keep_sigterm  # noqa: F401  (fixture)

ARCH = "qwen1.5-0.5b"
SHAPE = ShapeSpec("tiny", 32, 4, "train")


def _bits(t) -> bytes:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _same_tree(a, b) -> None:
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert _bits(x) == _bits(y), path


def _reference_state(label):
    """A reference train state (numpy leaves) of the smoke model, with
    8-bit moments under quantized full training."""
    tech = jtech(label)
    bits = 8 if tech.quant != "none" and tech.peft == "none" else 32
    state, _ = jinit(JLM(get_config(ARCH, reduced=True)), tech,
                     jax.random.PRNGKey(0), jopt.AdamWConfig(state_bits=bits))
    state = jax.device_get(state)
    # distinct values in the moments and counters: a zero tree would hide
    # a leaf read from the wrong file
    rng = np.random.default_rng(1)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return rng.standard_normal(x.shape).astype(x.dtype)
        if x.dtype == np.int32:
            return np.asarray(7 + rng.integers(0, 5, x.shape), np.int32)
        return x

    state["opt"] = jax.tree_util.tree_map(fill, state["opt"])
    state["step"] = np.int32(7)
    return state


# --------------------------------------------------------------------------
# the manager (tests/test_substrate.py's cases)
# --------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "opt": {"m": torch.ones(5),
                     "step": torch.tensor(7, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, state)
    assert mgr.all_steps() == [20, 30]       # retention
    restored, step = mgr.restore(state)
    assert step == 30
    _same_tree(restored, state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_checkpoint_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": torch.ones(2)})
    # a preempted save: a step directory without the marker, and a .tmp
    broken = tmp_path / "step_000000009"
    broken.mkdir()
    (broken / "manifest.json").write_text("{}")
    (tmp_path / "step_000000011.tmp").mkdir()
    assert mgr.latest_step() == 5            # partial writes ignored
    assert (tmp_path / "step_000000005" / COMMIT_MARKER).exists()


def test_checkpoint_async_save_snapshots_first(tmp_path):
    """An async save writes the state as it was at ``save``: the step may
    update it in place while the writer runs."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.ones((256, 256))}
    mgr.save(1, state, blocking=False)
    state["w"].add_(1.0)                     # the next step, in place
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(state)
    assert torch.equal(restored["w"], torch.ones((256, 256)))


def test_restore_refuses_another_shape(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="w"):
        mgr.restore({"w": torch.ones(5)})


# --------------------------------------------------------------------------
# the reference's layout, both ways
# --------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["F+R+Z3", "Q8", "Q", "QL+Q8"])
def test_layout_is_the_references_byte_for_byte(tmp_path, label):
    """The same train state saved by each package: the same manifest and
    the same bytes in every leaf file (QTensor, LoRATensor and Opt8
    leaves named and numbered as the reference flattens them)."""
    state = _reference_state(label)
    JManager(str(tmp_path / "ref")).save(3, state)
    CheckpointManager(str(tmp_path / "port")).save(
        3, train_state_from_jax(state, "cpu"))
    dirs = [tmp_path / side / "step_000000003" for side in ("ref", "port")]
    manifests = [json.loads((d / "manifest.json").read_text())
                 for d in dirs]
    assert manifests[0] == manifests[1]
    paths = [leaf["path"] for leaf in manifests[0]["leaves"]]
    assert any("['params']" in p for p in paths)
    if label == "Q8":
        assert "['opt']['m']['embed'][<flat index 0>]" in paths
        assert "['params']['embed'].scale" in paths
    if label == "QL+Q8":
        assert "['params']['blocks']['pos0']['mix']['wq'].base.data" in paths
    for leaf in manifests[0]["leaves"]:
        files = [np.load(d / (leaf["file"] + ".npy")) for d in dirs]
        assert files[0].dtype == files[1].dtype, leaf["path"]
        assert files[0].tobytes() == files[1].tobytes(), leaf["path"]


@pytest.mark.parametrize("label", ["F+R+Z3", "Q8"])
def test_managers_read_each_others_checkpoints(tmp_path, label):
    """A checkpoint of the port read by the reference's manager, and one
    of the reference read by the port's, both bitwise the state saved."""
    state = _reference_state(label)
    port_state = train_state_from_jax(state, "cpu")
    CheckpointManager(str(tmp_path / "port")).save(4, port_state)
    back, step = JManager(str(tmp_path / "port")).restore(
        jax.tree_util.tree_map(jnp.asarray, state))
    assert step == 4
    _same_tree(from_jax_numpy(jax.device_get(back)), port_state)
    JManager(str(tmp_path / "ref")).save(5, state)
    like = train_state_from_jax(_reference_state(label), "cpu")
    restored, step = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 5
    _same_tree(restored, port_state)
    assert all(t.requires_grad == u.requires_grad for (_, t), (_, u) in
               zip(tree_paths(restored), tree_paths(like)))


# --------------------------------------------------------------------------
# Trainer: resume, the emergency save
# --------------------------------------------------------------------------


def _run(label, steps, resume, d, **kw):
    cfg = port_config(ARCH, reduced=True)
    tech = technique_from_label(label)
    opt = (topt.AdamWConfig(lr=1e-3, warmup=1, state_bits=8)
           if tech.quant != "none" and tech.peft == "none"
           else topt.AdamWConfig(lr=1e-3, warmup=1))
    tr = Trainer(cfg, SHAPE, tech,
                 TrainerConfig(steps=steps, checkpoint_every=2,
                               checkpoint_dir=str(d), resume=resume,
                               log_every=1, **kw), opt, device="cpu")
    return tr, tr.run()


@pytest.mark.parametrize("label", ["F+R+Z3", "Q8", "QL+Q8"])
def test_resume_equals_an_uninterrupted_run(tmp_path, label,
                                            keep_sigterm):  # noqa: F811
    """Kill-and-resume: 2 steps, a save, a new Trainer resuming at step 2
    and running to 4; its params, moments and step counters bitwise those
    of 4 straight steps (tests/test_substrate.py holds the reference's to
    1e-6)."""
    full, out_full = _run(label, 4, "none", tmp_path / "a",
                          async_checkpoint=False)
    _run(label, 2, "none", tmp_path / "b")
    resumed, out = _run(label, 4, "auto", tmp_path / "b")
    assert resumed.start_step == 2
    assert out["final_step"] == 4 and [h["step"] for h in out["history"]] \
        == [3, 4]
    assert int(resumed.state["step"]) == int(full.state["step"]) == 4
    _same_tree(resumed.state, full.state)
    for a, b in zip(out["history"], out_full["history"][2:]):
        assert a["loss"] == b["loss"]
    assert resumed.ckpt.all_steps() == [2, 4]


def test_sigterm_ends_in_an_emergency_save(tmp_path, keep_sigterm):  # noqa: F811
    """SIGTERM during step 2 stops the loop at that step's boundary and
    saves step 2, blocking, whatever ``checkpoint_every`` says."""
    cfg = port_config(ARCH, reduced=True)
    tr = Trainer(cfg, SHAPE, technique_from_label("F+R+Z3"),
                 TrainerConfig(steps=6, checkpoint_every=100,
                               checkpoint_dir=str(tmp_path), log_every=1),
                 device="cpu")
    step_fn = tr.step_fn

    def preempted(state, batch):
        out = step_fn(state, batch)
        if int(state["step"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.step_fn = preempted
    out = tr.run()
    assert out["final_step"] == 2
    assert tr.ckpt.all_steps() == [2]
    restored, step = tr.ckpt.restore(tr.state)
    assert step == 2
    _same_tree(restored, tr.state)


def test_a_dropped_trainer_is_collected(tmp_path,
                                       keep_sigterm):  # noqa: F811
    """The SIGTERM handler is ``run()``'s only: before and after a run the
    process's previous handler is in place, so nothing outside keeps a
    dropped ``Trainer`` (and its state) alive."""
    import gc
    import weakref
    before = signal.getsignal(signal.SIGTERM)
    tr = Trainer(port_config(ARCH, reduced=True), SHAPE,
                 technique_from_label("F+R"),
                 TrainerConfig(steps=1, log_every=1), device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    assert tr.run()["final_step"] == 1
    assert signal.getsignal(signal.SIGTERM) is before
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None


# --------------------------------------------------------------------------
# the prefetcher and the CLI
# --------------------------------------------------------------------------


def test_prefetcher_overlaps():
    """Mirrors tests/test_substrate.py::test_prefetcher_overlaps."""
    ds = SyntheticLM(DataConfig(vocab_size=100, seq_len=16, global_batch=2))
    pf = Prefetcher(iter(ds))
    b1 = next(pf)
    b2 = next(pf)
    assert b1["tokens"].shape == (2, 16)
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    pf.stop()
    assert not pf.t.is_alive()


def test_prefetcher_copies_to_the_device_in_order():
    """With a device the batches arrive as tensors there, in the stream's
    order, equal to ``batch_at``; ``stop`` ends the worker."""
    ds = SyntheticLM(DataConfig(vocab_size=100, seq_len=16, global_batch=2))
    pf = Prefetcher(iter(ds), device="cpu", depth=3)
    for step in range(5):
        got = next(pf)
        want = ds.batch_at(step)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    pf.stop()
    assert not pf.t.is_alive()


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys,
                                          keep_sigterm):  # noqa: F811
    """``--checkpoint-dir`` saves at the end of a run cut by SIGTERM;
    ``--resume auto`` continues the stream from that step."""
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--technique", "Q8", "--checkpoint-dir", str(tmp_path)]
    real = Trainer._batch_for

    def preempted(self, step):           # SIGTERM during the second step
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step)

    Trainer._batch_for = preempted
    try:
        train_cli.main(argv + ["--steps", "5"])
    finally:
        Trainer._batch_for = real
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    capsys.readouterr()
    train_cli.main(argv + ["--steps", "3", "--resume", "auto"])
    out = capsys.readouterr().out
    assert "resumed at step 2" in out and "step      3  loss" in out
    assert "step      2  loss" not in out
