"""Training on a ``DeviceMesh`` (``repro_torch.train.mesh_step``) against
the port's one-device step: spawned gloo ranks (``tests/_torch_dist.py``)
train two steps in fp32 at meshes (4, 1), (2, 2) and (1, 4), remat on and
off, with the state placed by ``state_shardings``; FSDP and q8 moments at
(2, 2). The losses, and the parameters and both moments after two steps,
equal the one-device run's within 1e-4 of each leaf's largest value (the
bound of ``tests/test_torch_train.py``). The q8 run is held step by step
to the one-device step from the mesh run's own state (the same bound, ``q``
within one quantum). A q8 block rounds its small second moments to 0, and
where the gradient is small too the step m/(sqrt(v) + eps) is large and
follows the gradient's last digits, which the ranks' sum of shares sets
apart from one batch's: step 2's parameters are held within the bound
beyond lr x the step's change for a gradient change of 1e-4 of the leaf's
largest gradient (the gradients' own bound). The
configs are the smoke configs of mamba2-780m, yi-9b (a GQA architecture:
its smoke config gets 2 KV heads for 4 query heads, so the grouping runs),
qwen3-moe (MoE: capacity and slots are the whole batch's, the trap of a
data-parallel split) and jamba (hybrid, MoE), each with a 16,384-id
vocabulary, so that its embedding (and untied head) of 2^20 entries gets
the ZeRO extension over ``data`` that the rules give a leaf of that size.
One spawn a config runs every mesh in turn; each has a join timeout."""

import os

import pytest
import torch

from _torch_dist import (batches, initial_state, run_ranks, smoke_cfg,
                         train_worker)
from repro_torch.optim.adamw import (AdamWConfig, cosine_schedule, dequantize_q8,
                                     param_nodes)
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.tree import leaves_with_paths, tree_map

BOUND = 1e-4
STEPS = 2
VOCAB = 16384
CONFIGS = {"mamba2-780m": {}, "yi-9b": {"n_kv_heads": 2},
           "qwen3-moe-30b-a3b": {}, "jamba-1.5-large-398b": {}}
MESHES = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_device(cfg, q8: bool, state=None, steps=range(STEPS)):
    """The one-device run's losses and states after each of ``steps`` (from
    ``state``, by default the initial one)."""
    opt = AdamWConfig(quantized_moments=q8)
    state = initial_state(cfg, opt) if state is None else state
    step = make_train_step(cfg, opt)
    losses, states = [], []
    all_batches = batches(cfg, STEPS)
    for i in steps:
        state, metrics = step(state, all_batches[i])
        losses.append(float(metrics["loss"]))
        states.append(tree_map(torch.clone, state))
    return losses, states


def q8_step_allowance(state, batch, cfg) -> dict:
    """lr x |s(g +- d) - s(g)| for the q8 Adam step s of every parameter
    entry from ``state`` with the one-device gradient g of ``batch``, d =
    BOUND x the leaf's largest |g|: what the gradients' own bound lets the
    step move (fp64)."""
    opt = AdamWConfig(quantized_moments=True)
    _, grads = loss_and_grads(state["params"], batch, cfg)
    flat = dict(leaves_with_paths(grads))
    norm = sum(float(g.double().square().sum()) for g in flat.values()) ** 0.5
    clip = min(1.0, opt.grad_clip / (norm + 1e-9))
    count = int(state["opt"]["count"]) + 1
    bc1, bc2 = 1 - opt.b1 ** count, 1 - opt.b2 ** count
    lr = opt.lr * float(cosine_schedule(state["step"]))
    out = {}
    nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"], grads)
    for (path, _), (p, m, v, g) in zip(leaves_with_paths(state["params"]), nodes):
        M = dequantize_q8(m, p.shape).double()
        V = dequantize_q8(v, p.shape).double()
        g = g.double() * clip

        def s(x):
            mf = opt.b1 * M + (1 - opt.b1) * x
            vf = opt.b2 * V + (1 - opt.b2) * x * x
            return (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps)

        d = BOUND * float(g.abs().max())
        out[path] = lr * torch.maximum((s(g + d) - s(g)).abs(), (s(g - d) - s(g)).abs())
    return out


def assert_close_state(got, want, what: str, allowance=None) -> None:
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert g.keys() == w.keys(), what
    for k in w:
        a, b = g[k], w[k]
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        if k.endswith("/q"):
            assert int((a.int() - b.int()).abs().max()) <= 1, (what, k)
            continue
        bound = BOUND * max(float(b.float().abs().max()), 1e-30)
        diff = (a.double() - b.double()).abs()
        if allowance is not None:
            diff = diff - allowance[k] * (1 + 1e-6)
        err = float(diff.max())
        assert err <= bound, f"{what} {k}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_mesh_training_is_the_one_device_run(arch, tmp_path):
    cfg = smoke_cfg(arch, VOCAB, **CONFIGS[arch])
    jobs = [(f"m{d}x{m}-remat{int(r)}", (d, m), r, False, False, STEPS, False)
            for d, m in MESHES for r in (True, False)]
    jobs += [("fsdp", (2, 2), True, False, True, STEPS, False),
             ("q8", (2, 2), True, True, False, STEPS, False)]
    out = run_ranks(4, train_worker, (cfg, jobs), tmp_path)
    plain = one_device(cfg, False)
    for name, _, _, q8, _, _, _ in jobs:
        got = torch.load(os.path.join(out, f"{name}.pt"), weights_only=False)
        allow = [None] * STEPS
        if q8:  # step by step, from the mesh run's own state
            losses, states = one_device(cfg, True, steps=[0])
            more = one_device(cfg, True, tree_map(torch.clone, got["states"][0]), steps=[1])
            losses, states = losses + more[0], states + more[1]
            allow[1] = q8_step_allowance(got["states"][0], batches(cfg, STEPS)[1], cfg)
        else:
            losses, states = plain
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= BOUND * abs(b), (name, got["losses"], losses)
        for i, (g, w) in enumerate(zip(got["states"], states)):
            what = f"{arch} {name} step {i + 1}"
            assert int(g["step"]) == int(w["step"]) == 50 + i + 1, what
            assert int(g["opt"]["count"]) == int(w["opt"]["count"]), what
            assert_close_state(g["params"], w["params"], f"{what} params", allow[i])
            assert_close_state(g["opt"], w["opt"], f"{what} moments")
