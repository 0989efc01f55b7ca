"""The vision-language family (internvl2-26b) in the port against the JAX
package at smoke size (2 layers, d_model 64, 4 query heads over 2 KV
heads, 8 patches) on bridged weights: ``forward``, ``prefill`` plus
greedy ``decode_step``s, ``loss`` and its gradients under both
``attn_impl`` values (tests/test_torch_encdec.py's checks and limits);
``frontend_proj`` prepending the patches, the prefill ``lengths`` (patches
plus tokens), the loss over the token span only, the reference's
default-``max_len`` clipping, ``batch_specs``, and the engine serving the
family text-only, as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import build as rbuild
from repro.core.config import ShapeSpec
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch.build import batch_specs, random_batch
from repro_torch.serving.engine import Engine, Request

from test_torch_encdec import (IMPLS, BF16, assert_logits_close,
                               check_forward, check_loss_and_grads,
                               check_prefill_and_decode, f32, inputs,
                               models, weights)

ARCH = "internvl2-26b"


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread: the driver runs six test processes
    at once, and each one's default thread pool over every core slows
    all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_forward_matches_reference(port_impl, jax_impl):
    """Logits over the F patches and the T tokens (B, F + T, V)."""
    check_forward(ARCH, port_impl, jax_impl)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_prefill_and_decode_match_reference(port_impl, jax_impl):
    """``max_len`` >= F + T + new tokens: the prefill lengths are F + T
    and the four decode steps land in free slots."""
    _, ct = check_prefill_and_decode(ARCH, port_impl, jax_impl, max_len=24)
    assert tuple(ct["pos0"]["k"].shape) == (2, 2, 24, 2, 16)


def test_prefill_default_max_len_clips_like_the_reference():
    """The reference's default ``max_len`` is T, not F + T: the prefill
    cache then holds exactly the F + T prompt positions, and each decode
    write lands clipped on the last slot (blocks.py:96). The port gives
    the same logits for the same call."""
    model, params, port, tparams = models(ARCH, "naive", "naive")
    tok, _, fe = inputs(model.cfg, seed=4)
    lj, cj, nj = model.prefill(params, {"tokens": jnp.asarray(tok),
                                        "frontend_embeds": jnp.asarray(fe)})
    lt, ct, nt = port.prefill(tparams, torch.from_numpy(tok),
                              frontend_embeds=from_jax_numpy(fe))
    f, t = model.cfg.frontend_len, tok.shape[1]
    assert nt.tolist() == np.asarray(nj).tolist() == [f + t] * 2
    assert tuple(ct["pos0"]["k"].shape) == cj["pos0"]["k"].shape
    assert ct["pos0"]["k"].shape[2] == f + t
    for _ in range(2):
        nxt = f32(lj).argmax(-1).astype(np.int32)[:, None]
        lj, cj = model.decode_step(params, cj, jnp.asarray(nxt), nj)
        lt, ct = port.decode_step(tparams, ct, torch.from_numpy(nxt), nt)
        nj, nt = nj + 1, nt + 1
        assert_logits_close(lt, lj)
    np.testing.assert_allclose(f32(ct["pos0"]["k"]), f32(cj["pos0"]["k"]),
                               **BF16)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_loss_and_grads_match_reference(port_impl, jax_impl):
    """The loss counts the token span only (labels (B, T) against F + T
    positions); every leaf's gradient, ``frontend_proj``'s included."""
    check_loss_and_grads(ARCH, port_impl, jax_impl)


def test_loss_counts_the_token_span_only():
    """Labels over the patches would not fit: the loss equals the CE of
    the forward's logits at the token positions."""
    _, _, port, tparams = models(ARCH, "naive", "naive")
    tok, lab, fe = inputs(port.cfg, seed=5)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
             "frontend_embeds": from_jax_numpy(fe)}
    with torch.no_grad():
        loss, _ = port.loss(tparams, batch)
    logits = port.forward(tparams, batch["tokens"],
                          frontend_embeds=batch["frontend_embeds"])
    f = port.cfg.frontend_len
    ce = torch.nn.functional.cross_entropy(
        logits[:, f:].float().reshape(-1, logits.shape[-1]),
        batch["labels"].long().reshape(-1), ignore_index=-1)
    assert abs(float(loss) - float(ce)) < 1e-5


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_batch_specs_match_the_reference_builder(arch):
    """``batch_specs``: the reference builder's stand-ins (vlm: patches
    plus ``t - F`` tokens; encdec: frames plus ``t`` tokens), and a
    ``random_batch`` of that layout trains through ``loss``."""
    cfg = port_config(arch, reduced=True)
    want = rbuild.batch_specs(weights(arch)[0], ShapeSpec(
        "cell", 24, 2, "train"), _NoMesh(), with_labels=True)
    got = batch_specs(cfg, 2, 24)
    assert set(got) == set(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape
        assert str(dtype).endswith(str(want[name].dtype))
    batch = random_batch(cfg, 2, 24, device="cpu")
    _, _, port, tparams = models(arch, "naive", "naive")
    with torch.no_grad():
        loss, _ = port.loss(tparams, batch)
    assert bool(torch.isfinite(loss))


class _NoMesh:
    """The reference builder's sharding context without a mesh."""
    mesh = None


def test_engine_serves_the_family_text_only():
    """The engine runs the vlm decoder on text prompts (no frontend), as
    the reference's engine does: greedy streams equal the port's own
    ``prefill``/``decode_step`` stream."""
    _, _, port, tparams = models(ARCH, "naive", "naive")
    prompt = np.random.default_rng(6).integers(1, 256, 9).tolist()
    eng = Engine(port_config(ARCH, reduced=True), tparams, max_batch=2,
                 n_blocks=16, block_size=8, device="cpu")
    eng.submit(Request(rid=0, tokens=prompt, max_new_tokens=4))
    [done] = eng.run(max_steps=50)
    logits, cache, n = port.prefill(tparams, torch.tensor([prompt]),
                                    max_len=16)
    want = [int(logits.argmax(-1))]
    for _ in range(3):
        logits, cache = port.decode_step(tparams, cache,
                                         torch.tensor([[want[-1]]]), n)
        n = n + 1
        want.append(int(logits.argmax(-1)))
    assert done.output == want
