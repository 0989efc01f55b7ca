"""Every arch of the reference's registry in the port, at smoke size (the
port's counterpart of tests/test_system.py:38): the port's config equals
the reference's, full and reduced; a forward gives finite logits of the
reference's shape; and one ``F`` train step (the flash route's plain
version on the CPU) gives a finite loss that agrees with the reference's
loss at the same bridged weights and numpy-seeded batch, and advances the
step counter.

The reference's loss is compiled without XLA's excess precision
(tests/test_torch_train_families.py says why), with its builder's ``F``
attention (``"chunked"``), and the port's is read from the train step's
metrics. Limit: 5e-3 over the 2 x 32 tokens (measured on the CPU: at
most 2.3e-3, seamless's four stacks of bf16 roundings, then 1.7e-3,
chatglm3's; mamba2 bit-equal; tests/test_torch_train.py holds 2e-3 over
twice the tokens).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.launch.build import make_model as ref_make_model
from repro.core.config import technique_from_label as ref_technique
from repro_torch.bridge import from_jax_numpy, train_state_from_jax
from repro_torch.configs import get_config as port_config
from repro_torch.configs import list_archs as port_archs
from repro_torch.core.config import technique_from_label
from repro_torch.launch.build import build_train
from repro_torch.models.lm import LM as PortLM
from repro_torch.train.step import init_train_state

B, T = 2, 32
LOSS_ATOL = 5e-3
ARCHS = list_archs()


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread: the driver runs six test processes
    at once, and each one's default thread pool over every core slows
    all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if cfg.frontend != "none":
        out["frontend_embeds"] = np.asarray(jnp.asarray(rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)), jnp.bfloat16))
    return out


def test_registry_matches_reference():
    assert sorted(port_archs()) == sorted(ARCHS)
    assert len(ARCHS) == 13


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke_forward_and_train_step(arch):
    for reduced in (False, True):
        assert (dataclasses.asdict(port_config(arch, reduced=reduced)) ==
                dataclasses.asdict(get_config(arch, reduced=reduced)))
    cfg = get_config(arch, reduced=True)
    tech = ref_technique("F")
    model = ref_make_model(cfg, tech, None)
    params = model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    want = jax.jit(lambda p, b: model.loss(p, b)[0]).lower(
        params, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, jb)

    pcfg = port_config(arch, reduced=True)
    step, ptech, port, opt_cfg = build_train(pcfg, technique_from_label("F"),
                                             device="cpu")
    assert isinstance(port, PortLM) and port.attn_impl == "flash"
    state, _ = init_train_state(port, ptech, opt_cfg=opt_cfg)
    state["params"] = train_state_from_jax(
        {"params": jax.device_get(params)}, "cpu")["params"]
    tb = from_jax_numpy(batch)
    logits = port.forward(state["params"], tb["tokens"],
                          frontend_embeds=tb.get("frontend_embeds"))
    n_front = cfg.frontend_len if cfg.family == "vlm" else 0
    assert tuple(logits.shape) == (B, n_front + T, port.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    state, metrics = step(state, tb)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and int(state["step"]) == 1
    assert abs(loss - float(want)) < LOSS_ATOL, (loss, float(want))
