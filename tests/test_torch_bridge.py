"""Weight bridge: the JAX package's params cross into the port and back
bit for bit (bf16 leaves, stacked blocks, padded vocab, tied embeddings),
for mamba2-130m also its f32 leaves (``a_log``, ``d_skip``,
``dt_bias``) and the zero-width FFN leaves of its ``d_ff=0`` config, and
for the llama2 family its untied head and grouped KV heads."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.lm import LM
from repro_torch.bridge import from_jax_numpy, to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models.lm import LM as PortLM
from repro_torch.models.params import tree_paths


@pytest.fixture(scope="module")
def jax_params():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    return jax.device_get(LM(cfg).init(jax.random.PRNGKey(0)))


def test_roundtrip_is_bitwise(jax_params):
    back = to_numpy(from_jax_numpy(jax_params))
    want = dict(tree_paths(jax_params))
    got = dict(tree_paths(back))
    assert got.keys() == want.keys()
    for path, a in want.items():
        b = got[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(
            np.asarray(b).view(np.uint8), np.asarray(a).view(np.uint8),
            err_msg=path)


def test_bridged_tree_matches_port_specs(jax_params):
    """Keys, shapes and dtypes line up with the port's own param specs:
    stacked (n_periods, ...) blocks, the padded vocabulary, no head leaf
    under tied embeddings."""
    port = from_jax_numpy(jax_params)
    specs = dict(tree_paths(
        PortLM(port_config("qwen1.5-0.5b", reduced=True),
               device="cpu").param_specs()))
    got = dict(tree_paths(port))
    assert got.keys() == specs.keys()
    assert "head" not in port
    for path, ps in specs.items():
        assert tuple(got[path].shape) == ps.shape, path
        assert got[path].dtype == ps.dtype, path
    assert port["embed"].shape[0] == 512          # 256 padded to 512
    assert port["blocks"]["pos0"]["mix"]["wq"].shape[0] == 2   # n_periods


def test_port_init_is_seeded_and_fan_in_scaled():
    model = PortLM(port_config("qwen1.5-0.5b", reduced=True), device="cpu")
    a, b = model.init(0), model.init(0)
    c = model.init(1)
    for (path, x), (_, y), (_, z) in zip(tree_paths(a), tree_paths(b),
                                         tree_paths(c)):
        assert torch.equal(x, y), path
    assert not torch.equal(a["embed"], c["embed"])
    wq = a["blocks"]["pos0"]["mix"]["wq"].float()
    # fan-in of wq is d_model = 64 (the stacked axis is excluded)
    assert abs(wq.std().item() - 1 / 8) < 0.01
    assert torch.all(a["blocks"]["pos0"]["mix"]["bq"] == 0)
    assert torch.all(a["final_ln"] == 1)


def _mamba2_params(d_ff=None):
    cfg = get_config("mamba2-130m", reduced=True)
    if d_ff is not None:         # the full config's FFN width at smoke size
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    return cfg, jax.device_get(LM(cfg).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("d_ff", [None, 0], ids=["smoke", "d_ff=0"])
def test_mamba2_params_cross_bitwise(d_ff):
    cfg, params = _mamba2_params(d_ff)
    port = from_jax_numpy(params)
    mix = port["blocks"]["pos0"]["mix"]
    for leaf in ("a_log", "d_skip", "dt_bias"):
        assert mix[leaf].dtype == torch.float32
        assert tuple(mix[leaf].shape) == (2, cfg.n_ssm_heads)
    ffn = port["blocks"]["pos0"]["ffn"]
    assert tuple(ffn["w_gate"].shape) == (2, 64, cfg.d_ff)
    assert tuple(ffn["w_down"].shape) == (2, cfg.d_ff, 64)
    back = to_numpy(port)
    want, got = dict(tree_paths(params)), dict(tree_paths(back))
    assert got.keys() == want.keys()
    for path, a in want.items():
        b = got[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(
            np.asarray(b).view(np.uint8), np.asarray(a).view(np.uint8),
            err_msg=path)
    port_cfg = port_config("mamba2-130m", reduced=True)
    if d_ff is not None:
        port_cfg = dataclasses.replace(port_cfg, d_ff=d_ff)
    specs = dict(tree_paths(PortLM(port_cfg, device="cpu").param_specs()))
    got = dict(tree_paths(port))
    assert got.keys() == specs.keys()
    for path, ps in specs.items():
        assert tuple(got[path].shape) == ps.shape, path
        assert got[path].dtype == ps.dtype, path


@pytest.mark.parametrize("arch", ["llama2-7b", "llama2-13b", "llama2-70b",
                                  "granite-3-2b", "qwen2.5-14b",
                                  "chatglm3-6b"])
def test_llama2_params_cross_bitwise(arch):
    """An untied ``head`` leaf (d_model, vocab) or none under tied
    embeddings (granite), QKV biases where the config has them (qwen2.5,
    chatglm3), and grouped KV projections; the tree crosses bitwise both
    ways and lines up with the port's own specs."""
    cfg = get_config(arch, reduced=True)
    params = jax.device_get(LM(cfg).init(jax.random.PRNGKey(0)))
    port = from_jax_numpy(params)
    if cfg.tie_embeddings:
        assert "head" not in port
    else:
        assert tuple(port["head"].shape) == (64, 512)    # 256 padded
    mix = port["blocks"]["pos0"]["mix"]
    assert ("bq" in mix) == cfg.qkv_bias
    assert tuple(mix["wk"].shape) == (2, 64, cfg.n_kv_heads, 16)
    back = to_numpy(port)
    want, got = dict(tree_paths(params)), dict(tree_paths(back))
    assert got.keys() == want.keys()
    for path, a in want.items():
        b = got[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(
            np.asarray(b).view(np.uint8), np.asarray(a).view(np.uint8),
            err_msg=path)
    specs = dict(tree_paths(PortLM(port_config(arch, reduced=True),
                                   device="cpu").param_specs()))
    got = dict(tree_paths(port))
    assert got.keys() == specs.keys()
    for path, ps in specs.items():
        assert tuple(got[path].shape) == ps.shape, path
        assert got[path].dtype == ps.dtype, path


def test_port_ssm_init_ranges():
    """The port's own seeded draws of the SSM leaves follow the
    reference's initializers: A_log in [log 1, log 16], softplus(dt_bias)
    in [1e-3, 1e-1], D = 1, conv bias 0."""
    model = PortLM(port_config("mamba2-130m", reduced=True), device="cpu")
    a, b = model.init(0), model.init(0)
    for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), path
    mix = a["blocks"]["pos0"]["mix"]
    assert mix["a_log"].dtype == torch.float32
    assert float(mix["a_log"].min()) >= 0.0
    assert float(mix["a_log"].max()) <= float(np.log(16.0)) + 1e-6
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    assert torch.all(mix["d_skip"] == 1) and torch.all(mix["conv_b"] == 0)


def _to_reference_classes(tree):
    """The port's QTensor/LoRATensor of numpy fields as the reference's
    classes, so jax can flatten and compare the whole tree."""
    from repro.peft.lora import LoRATensor as JLoRA
    from repro.quant.qtensor import QTensor as JQ
    from repro_torch.peft.lora import LoRATensor
    from repro_torch.quant.qtensor import QTensor
    if isinstance(tree, dict):
        return {k: _to_reference_classes(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return JQ(_to_reference_classes(tree.data),
                  _to_reference_classes(tree.scale), tree.scale2, tree.kind,
                  tree.shape, tree.dtype_orig)
    if isinstance(tree, LoRATensor):
        return JLoRA(_to_reference_classes(tree.base), tree.a, tree.b,
                     scaling=tree.scaling)
    return tree


@pytest.mark.parametrize("label", ["QL+Q8", "L"])
def test_lora_train_state_crosses_and_back_bitwise(label):
    """A LoRA train state from the reference (int8 QTensors, LoRATensors,
    m/v trees with None at frozen leaves and QTensors of None fields)
    crosses into the port and back with the same tree structure, static
    fields included, and the same bytes in every leaf."""
    from repro.core.config import technique_from_label
    from repro.train.step import init_train_state
    from repro_torch.bridge import train_state_from_jax
    from repro_torch.peft.lora import LoRATensor
    from repro_torch.quant.qtensor import QTensor
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    state = jax.device_get(init_train_state(
        LM(cfg), technique_from_label(label, lora_rank=4),
        jax.random.PRNGKey(0))[0])
    port = train_state_from_jax(state, "cpu")
    wq = port["params"]["blocks"]["pos0"]["mix"]["wq"]
    assert isinstance(wq, LoRATensor) and wq.scaling == 4.0
    assert wq.a.requires_grad and wq.b.requires_grad
    if label == "QL+Q8":
        assert isinstance(wq.base, QTensor) and wq.base.kind == "int8"
        assert wq.base.dtype_orig == torch.bfloat16
        assert not wq.base.data.requires_grad
        assert port["opt"]["m"]["embed"].data is None
    else:
        assert not wq.base.requires_grad
    assert port["opt"]["m"]["final_ln"] is None
    back = _to_reference_classes(to_numpy(port))
    want_leaves, want_def = jax.tree_util.tree_flatten(state)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for a, b in zip(want_leaves, got_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(np.atleast_1d(b).view(np.uint8),
                                      np.atleast_1d(a).view(np.uint8))
