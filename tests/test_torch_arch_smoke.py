"""The reference's per-architecture smoke cases (``tests/test_arch_smoke.py``)
re-run on the port for every architecture they cover, on the port's own
random parameters in the configs' bf16 on the CPU: forward shapes and
finiteness, one decode step against a fresh cache (a prefilled one for
whisper), prefill against forward's last position, and the gradient step
(``tests/test_arch_smoke.py:42``: loss and every gradient leaf finite, the
embedding's gradient nonzero). Also the loss and gradients of a MoE config
in fp32 against the reference's ``jax.value_and_grad`` on converted
parameters (1e-4 of each leaf's largest absolute value), the parameter
tree's layout against the reference's, ``build_params``' seeding, and the
bf16 conversion of a reference tree."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as R
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_reference
from repro_torch.models.model import (build_cache, build_params, demo_batch,
                                      model_forward, serve_decode, serve_prefill)
from repro_torch.models.transformer import abstract_params, block_at
from repro_torch.train.train_step import loss_and_grads
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = sorted(REGISTRY)
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke_state():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = REGISTRY[name].smoke()
            cache[name] = (cfg, build_params(cfg, seed=0, device=CPU))
        return cache[name]

    return get


def _finite(t) -> bool:
    return bool(torch.isfinite(t.float()).all())


@pytest.mark.parametrize("name", ARCHS)
def test_forward_shapes_and_finite(smoke_state, name):
    cfg, params = smoke_state(name)
    batch = demo_batch(cfg, batch=2, seq=32, kind="train", device=CPU)
    logits = model_forward(params, batch, cfg)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert logits.dtype == torch.bfloat16
    assert _finite(logits)


@pytest.mark.parametrize("name", ARCHS)
def test_train_grad_step(smoke_state, name):
    cfg, params = smoke_state(name)
    batch = demo_batch(cfg, batch=2, seq=32, kind="train", device=CPU)
    loss, grads = loss_and_grads(params, batch, cfg)
    assert _finite(loss)
    flat = leaves(grads)
    assert flat and all(_finite(g) for g in flat)
    assert [g.dtype for g in flat] == [p.dtype for p in leaves(params)]
    # embeddings must receive gradient
    assert float(grads["embed"].float().abs().sum()) > 0


def test_moe_loss_and_grads_are_the_reference():
    """MoE's scatter of tokens into expert buffers carries gradients: the
    loss and every gradient leaf of qwen3-moe's smoke config in fp32 equal
    the reference's ``jax.value_and_grad(loss_fn)`` within 1e-4 of each
    leaf's largest absolute value."""
    cfg = replace(REGISTRY["qwen3-moe-30b-a3b"].smoke(), dtype="float32")
    ref = R.build_params(cfg, seed=1)
    port = params_from_reference(jax.tree_util.tree_map(np.asarray, ref),
                                 device=CPU)
    batch = R.demo_batch(cfg, batch=2, seq=32, kind="train", seed=2)
    want_loss, want = jax.value_and_grad(R.loss_fn)(ref, batch, cfg)
    loss, grads = loss_and_grads(
        port, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}, cfg)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)
    got, want = dict(leaves_with_paths(grads)), dict(leaves_with_paths(
        jax.tree_util.tree_map(np.asarray, want)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        bound = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=bound,
                                   err_msg=k)
    assert float(np.abs(want["blocks/l0/ffn/w_gate"]).max()) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_shapes(smoke_state, name):
    cfg, params = smoke_state(name)
    cache = build_cache(cfg, batch=2, max_seq=64, device=CPU)
    if cfg.family == "encdec":
        # fill cross K/V via prefill
        batch = demo_batch(cfg, batch=2, seq=8, kind="prefill", device=CPU)
        _, cache = serve_prefill(params, batch, cfg, max_seq=64)
    tok = demo_batch(cfg, batch=2, seq=1, kind="decode", device=CPU)
    logits, cache2 = serve_decode(params, cache, tok, cfg)
    assert logits.shape == (2, cfg.vocab_size)
    assert _finite(logits)
    assert int(cache2["pos"]) == int(cache["pos"]) + 1


@pytest.mark.parametrize("name", ["yi-9b", "gemma2-2b", "mamba2-780m",
                                  "mixtral-8x22b", "jamba-1.5-large-398b"])
def test_prefill_then_decode_matches_forward(smoke_state, name):
    """Prefill's logits == forward's at the last position (bf16, the
    reference case's 2e-2), and one decode step from the prefill cache
    gives finite logits."""
    cfg, params = smoke_state(name)
    batch = demo_batch(cfg, batch=2, seq=16, kind="prefill", device=CPU)
    last = model_forward(params, batch, cfg, remat=False)[:, -1].float()
    pf, cache = serve_prefill(params, batch, cfg, max_seq=64)
    np.testing.assert_allclose(pf.float().numpy(), last.numpy(),
                               rtol=2e-2, atol=2e-2)
    tok = torch.argmax(pf, -1)[:, None].to(torch.int32)
    logits, _ = serve_decode(params, cache, {"token": tok}, cfg)
    assert _finite(logits)


def _layout(tree):
    return {k: _layout(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_parameter_tree_is_the_reference_layout(smoke_state, name):
    cfg, params = smoke_state(name)
    ref = jax.eval_shape(lambda: R.build_params(cfg, seed=0))
    assert _layout(params) == _layout(ref)
    cache = build_cache(cfg, batch=2, max_seq=24, device=CPU)
    assert _layout(cache) == _layout(jax.eval_shape(
        lambda: R.build_cache(cfg, batch=2, max_seq=24)))
    assert block_at(params["blocks"], cfg.n_blocks - 1).keys() == \
        params["blocks"].keys()
    abstract = abstract_params(cfg)
    assert _layout(abstract) == _layout(ref)
    assert {p.device.type for p in leaves(abstract)} == {"meta"}


def test_build_params_is_seeded_and_bf16_rounds_fp32():
    cfg = REGISTRY["jamba-1.5-large-398b"].smoke()
    a = build_params(cfg, seed=3, device=CPU)
    b = build_params(cfg, seed=3, device=CPU)
    c = build_params(cfg, seed=4, device=CPU)
    f = build_params(replace(cfg, dtype="float32"), seed=3, device=CPU)
    la, lb, lc, lf = (jax.tree_util.tree_leaves(t) for t in (a, b, c, f))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not all(torch.equal(x, y) for x, y in zip(la, lc))
    assert all(torch.equal(x, y.to(x.dtype)) for x, y in zip(la, lf))


def test_build_params_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_params(REGISTRY["yi-9b"].smoke(), seed=0)


def test_bf16_reference_tree_converts_bit_for_bit():
    # bf16 leaves beside fp32 ones (the router, A_log, D, dt_bias)
    cfg = REGISTRY["jamba-1.5-large-398b"].smoke()
    ref = R.build_params(cfg, seed=0)
    as_u16 = jax.tree_util.tree_map(
        lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
        else np.asarray(a), ref)
    for tree in (as_u16, jax.tree_util.tree_map(np.asarray, ref)):
        got = params_from_reference(tree, device=CPU)
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            if g.dtype == torch.bfloat16:
                np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                              np.asarray(w).view(np.int16))
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
