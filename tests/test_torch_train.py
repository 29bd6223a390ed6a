"""repro_torch.train against the JAX package's ``repro.train`` on mamba2-780m's
smoke config in fp32, on the reference's parameters converted by
``repro_torch.convert``: the loss and every gradient leaf against
``jax.value_and_grad(loss_fn)`` (the stacked block leaves included), one
``make_train_step`` step with plain and q8 moments and one with 2
microbatches (loss, parameters, moments, count, step) from a state at step
50, so the schedule's factor is not 0. Also: microbatches against a single
batch (``tests/test_system.py:246``), ``remat`` on and off, and the serve
step builders. Tolerance: 1e-4 of each leaf's largest absolute value (the
whole-model bound of ``test_torch_model.py``); q8 ``q`` within one
quantum."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.train import train_step as RT
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.models.model import (build_cache, build_params, demo_batch,
                                      loss_fn, serve_decode, serve_prefill)
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.train.train_step import (loss_and_grads, make_decode_step,
                                          make_prefill_step, make_train_step)
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

ARCH = "mamba2-780m"
BOUND = 1e-4
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with
    XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def close_tree(got, want, what: str, q_quantum: bool = False) -> None:
    """Every leaf of ``got`` within BOUND of the largest |leaf| of ``want``
    (q8 ``q`` leaves within one quantum when ``q_quantum``)."""
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(_np_tree(want)))
    assert g.keys() == w.keys(), what
    for k in w:
        a, b = g[k].numpy(), np.asarray(w[k])
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), (what, k)
        if k.endswith("/q"):
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(initial=0)
            assert diff <= (1 if q_quantum else 0), (what, k, diff)
            continue
        bound = BOUND * max(float(np.abs(b).max(initial=0)), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def pair():
    cfg = replace(ref_configs.REGISTRY[ARCH].smoke(), dtype="float32")
    ref = RM.build_params(cfg, seed=0)
    return cfg, ref, params_from_reference(_np_tree(ref), device=CPU)


def test_loss_and_grads_are_the_reference(pair):
    cfg, ref, port = pair
    batch = RM.demo_batch(cfg, 2, 32, kind="train")
    want_loss, want = jax.value_and_grad(RM.loss_fn)(ref, batch, cfg)
    before = [p.clone() for p in leaves(port)]
    loss, grads = loss_and_grads(port, _batch(batch), cfg)
    assert float(loss) == pytest.approx(float(want_loss), rel=BOUND)
    close_tree(grads, want, "grads")
    # the parameters are untouched and carry no autograd state
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(port)))
    assert not any(p.requires_grad for p in leaves(port))


def test_gradients_accumulate_into_the_stacked_leaves(pair):
    """Each block reads its slice of a stacked leaf through a view of one
    ``unbind``; the gradient of the stacked leaf has every block's slice,
    and equals the gradients taken through per-block copies of the
    leaves."""
    cfg, _, port = pair
    assert cfg.n_blocks == 2
    batch = _batch(RM.demo_batch(cfg, 2, 16, kind="train", seed=3))
    _, grads = loss_and_grads(port, batch, cfg)
    # in the autograd graph, one unbind feeds each stacked leaf (a select
    # per block would add a zero-filled gradient of the whole leaf a block)
    flat = {k: p.detach().requires_grad_() for k, p in leaves_with_paths(port)}
    loss = loss_fn(unflatten(port, list(flat.values())), batch, cfg)
    feeders: dict[int, set] = {}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if type(nxt).__name__ == "AccumulateGrad":
                feeders.setdefault(id(nxt.variable), set()).add(node.name())
            todo.append(nxt)
    for k, t in flat.items():
        if k.startswith("blocks/"):
            assert feeders[id(t)] == {"UnbindBackward0"}, (k, feeders[id(t)])
    for k, g in leaves_with_paths(grads["blocks"]):
        assert g.shape[0] == cfg.n_blocks, k
        assert all(torch.any(g[b] != 0) for b in range(cfg.n_blocks)), k
    # the same loss through leaves that are stacked from separate tensors
    split = tree_map(lambda v: [v[b].clone().requires_grad_()
                                for b in range(cfg.n_blocks)], port["blocks"])
    rebuilt = dict(port, blocks=tree_map(torch.stack, split))
    loss = loss_fn(rebuilt, batch, cfg)
    per_block = leaves(split)
    got = torch.autograd.grad(loss, [t for pair_ in per_block for t in pair_])
    for i, (k, g) in enumerate(leaves_with_paths(grads["blocks"])):
        for b in range(cfg.n_blocks):
            np.testing.assert_allclose(got[i * cfg.n_blocks + b].numpy(),
                                       g[b].numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{k} block {b}")


def _start_state(ref, opt_ref, step: int = 50):
    return {"params": ref, "opt": RA.init_state(ref, opt_ref),
            "step": jnp.int32(step)}


@pytest.mark.parametrize("quant,microbatches", [(False, 1), (True, 1), (False, 2)])
def test_train_step_is_the_reference(pair, quant, microbatches):
    """One step from step 50: the loss, the schedule's factor, the updated
    parameters, both moments, the count and the step."""
    cfg, ref, _ = pair
    opt_ref = RA.AdamWConfig(quantized_moments=quant)
    opt = AdamWConfig(quantized_moments=quant)
    batch = RM.demo_batch(cfg, 4, 16, kind="train", seed=1)
    st = _start_state(ref, opt_ref)
    port_st = state_from_reference(_np_tree(st), device=CPU)
    want, wm = RT.make_train_step(cfg, opt_ref, microbatches=microbatches)(st, batch)
    got, gm = make_train_step(cfg, opt, microbatches=microbatches)(
        port_st, _batch(batch))
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]), rel=BOUND)
    assert float(gm["lr_scale"]) == pytest.approx(float(wm["lr_scale"]), rel=1e-6)
    assert 0.0 < float(gm["lr_scale"]) < 1.0
    assert int(got["step"]) == int(want["step"]) == 51
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1
    close_tree(got["params"], want["params"], "params")
    close_tree(got["opt"]["m"], want["opt"]["m"], "m", q_quantum=quant)
    close_tree(got["opt"]["v"], want["opt"]["v"], "v", q_quantum=quant)


def test_microbatched_train_step_matches_single():
    """``tests/test_system.py::test_microbatched_train_step_matches_single``
    on the port (bf16, h2o-danube's smoke config)."""
    cfg = REGISTRY["h2o-danube-1.8b"].smoke()
    params = build_params(cfg, seed=0, device=CPU)
    opt = AdamWConfig(lr=0.0, weight_decay=0.0)
    batch = demo_batch(cfg, batch=4, seq=16, kind="train", device=CPU)
    losses = []
    for mb in (1, 2):
        p = tree_map(torch.clone, params)
        state = {"params": p, "opt": init_state(p, opt),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, m = make_train_step(cfg, opt, microbatches=mb)(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)
    with pytest.raises(ValueError, match="not a multiple"):
        make_train_step(cfg, opt, microbatches=3)(state, batch)


@pytest.mark.parametrize("name", [ARCH, "whisper-medium", "qwen3-moe-30b-a3b"])
def test_remat_gives_the_same_gradients(name):
    """Recomputing each block (and whisper's encoder layers) in the backward
    pass gives the gradients of keeping every activation, bit for bit."""
    cfg = replace(REGISTRY[name].smoke(), dtype="float32")
    params = build_params(cfg, seed=2, device=CPU)
    batch = demo_batch(cfg, 2, 16, kind="train", seed=4, device=CPU)
    l1, g1 = loss_and_grads(params, batch, cfg, remat=True)
    l0, g0 = loss_and_grads(params, batch, cfg, remat=False)
    assert torch.equal(l1, l0)
    for (k, a), (_, b) in zip(leaves_with_paths(g1), leaves_with_paths(g0)):
        assert torch.equal(a, b), k


def test_serve_step_builders(pair):
    cfg, _, port = pair
    pb = demo_batch(cfg, 2, 8, kind="prefill", seed=5, device=CPU)
    want, wcache = serve_prefill(port, pb, cfg, max_seq=12)
    got, gcache = make_prefill_step(cfg, max_seq=12)(port, pb)
    assert torch.equal(got, want)
    tok = {"token": torch.argmax(got, -1)[:, None].to(torch.int32)}
    clone = tree_map(torch.clone, gcache)
    want, _ = serve_decode(port, wcache, tok, cfg)
    got, _ = make_decode_step(cfg)(port, clone, tok)
    assert torch.equal(got, want)
    assert set(build_cache(cfg, 2, 12, device=CPU)) == {"blocks", "pos"}
