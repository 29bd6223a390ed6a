"""Tensor-parallel compute over ``model`` (``repro_torch.distributed.tp``,
the layers on their shards) against the port's one-device run and the
reference's.

Spawned gloo ranks (``tests/_torch_dist.py``) run each config at meshes
(1, 2), (1, 4) and (2, 2), in fp32 with the parameters placed by
``param_shardings`` (the state by ``state_shardings``):

* the mesh prefill of a (4, 16) batch and 4 decode steps against its cache
  give the one-device logits and cache within 1e-4 of the largest value;
* two train steps give the one-device losses, parameters and both moments
  within 1e-4 of each leaf's largest value, the parameters beyond lr x the
  change of each step for a gradient change of 1e-4 of the leaf's largest
  gradient (the gradients' own bound: Adam divides every entry by its own
  magnitude, so an entry whose gradient is small next to its leaf's
  follows the gradient's last digits, as ``tests/test_torch_mesh_train.py``
  says of q8);
* no leaf the rules shard over ``model`` is all-gathered over ``model``
  (no all-gather on the ``model`` group has the shape of one, whole or a
  block of it, by ``CollectiveCounter``'s groups), in the serve steps or in
  training;
* at (1, m), the flops of every matmul that reads a ``model``-sharded leaf
  (``FlopCounterMode``'s formulas, summed by leaf) are 1/m of the
  one-device run's;
* every replicated leaf's gradient is the same on each rank of a ``model``
  group.

The configs are the smoke configs of ``tests/test_torch_mesh_train.py``
(mamba2-780m with 514 ids, so its tied embedding is split by vocabulary
at m = 2 and by columns at m = 4; yi-9b with 2 KV heads, so its heads are
whole at m = 2 and gathered at m = 4; qwen3-moe and jamba, experts split
over ``model``), mixtral (experts split at m = 2 and 4), mixtral with 6
experts and 514 ids (each expert's width split and the embedding's
columns at m = 4) and whisper-medium (the encoder, and cross-attention in
prefill and decode). The (1, 4) prefill of yi-9b and mamba2 also equals
the reference's jitted prefill under ``use_mesh`` on 4 forced host
devices, on its own parameters converted, within 1e-4.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import (BATCH, DECODE_STEPS, SEQ, STEPS_TP, WeightFlops, batches,
                         initial_state, model_sharded, run_ranks, smoke_cfg,
                         tp_prefill_worker, tp_worker)
from repro_torch.distributed.sharding import param_shardings
from repro_torch.models.model import build_params, demo_batch, serve_decode, serve_prefill
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule, param_nodes
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-4
CONFIGS = {
    "mamba2-780m": ("mamba2-780m", 514, {}),
    "yi-9b": ("yi-9b", 512, {"n_kv_heads": 2}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", 512, {}),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", 512, {}),
    "mixtral-8x22b": ("mixtral-8x22b", 512, {}),
    "mixtral-e6": ("mixtral-8x22b", 514, {"n_experts": 6}),
    "whisper-medium": ("whisper-medium", 512, {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what: str, allowance=None) -> None:
    """Within BOUND of ``want``'s largest |value|, beyond ``allowance``."""
    bound = BOUND * max(float(want.float().abs().max()), 1e-30)
    diff = (got.double() - want.double()).abs()
    if allowance is not None:
        diff = diff - allowance * (1 + 1e-6)
    err = float(diff.max())
    assert got.shape == want.shape and err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def close_tree(got, want, what: str, allowance=None) -> None:
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert g.keys() == w.keys(), what
    for k in w:
        assert g[k].dtype == w[k].dtype, (what, k)
        close(g[k], w[k], f"{what} {k}", None if allowance is None else allowance[k])


def one_device(cfg):
    """The one-device serve steps (logits, cache, flops by leaf) and two
    train steps (losses, states), as the workers run them."""
    params = build_params(cfg, seed=0, device="cpu")
    weights = {t.untyped_storage().data_ptr(): p for p, t in leaves_with_paths(params)}
    batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
    with torch.no_grad(), WeightFlops(weights) as wf:
        logits, cache = serve_prefill(params, batch, cfg, max_seq=SEQ + DECODE_STEPS)
        steps = []
        for i in range(DECODE_STEPS):
            token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2 + i, device="cpu")
            d_logits, cache = serve_decode(params, cache, token, cfg)
            steps.append(d_logits)
    opt = AdamWConfig()
    state, step = initial_state(cfg, opt), make_train_step(cfg, opt)
    losses, allowance = [], None
    for b in batches(cfg, STEPS_TP):
        more = adam_allowance(state, b, cfg)
        allowance = more if allowance is None else {k: allowance[k] + more[k] for k in more}
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return {"logits": logits, "steps": steps, "cache": cache, "flops": dict(wf.flops),
            "losses": losses, "state": state, "params": params, "allowance": allowance}


def adam_allowance(state, batch, cfg) -> dict:
    """lr x |s(g +- d) - s(g)| for the AdamW step s of every parameter entry
    from ``state`` with the one-device gradient g of ``batch``, d = BOUND x
    the leaf's largest |g|: how far a gradient within the bound moves the
    step, which divides each entry by its own magnitude (fp64)."""
    opt = AdamWConfig()
    _, grads = loss_and_grads(state["params"], batch, cfg)
    flat = dict(leaves_with_paths(grads))
    norm = sum(float(g.double().square().sum()) for g in flat.values()) ** 0.5
    clip = min(1.0, opt.grad_clip / (norm + 1e-9))
    count = int(state["opt"]["count"]) + 1
    bc1, bc2 = 1 - opt.b1 ** count, 1 - opt.b2 ** count
    lr = opt.lr * float(cosine_schedule(state["step"]))
    out = {}
    nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"], grads)
    for (path, _), (_, m, v, g) in zip(leaves_with_paths(state["params"]), nodes):
        g = g.double() * clip

        def s(x, m=m.double(), v=v.double()):
            mf = opt.b1 * m + (1 - opt.b1) * x
            vf = opt.b2 * v + (1 - opt.b2) * x * x
            return (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps)

        d = BOUND * float(g.abs().max())
        out[path] = lr * torch.maximum((s(g + d) - s(g)).abs(), (s(g - d) - s(g)).abs())
    return out


def forbidden_shapes(params, sharded: set) -> set:
    """Each ``model``-sharded leaf's shape, and its blocks' shape."""
    out = set()
    for p, t in leaves_with_paths(params):
        if p in sharded:
            out.add(tuple(t.shape))
            if p.startswith(("blocks/", "enc_blocks/")):
                out.add(tuple(t.shape[1:]))
    return out


@pytest.mark.parametrize("case", list(CONFIGS))
def test_tensor_parallel_steps_are_the_one_device_run(case, tmp_path):
    arch, vocab, changes = CONFIGS[case]
    cfg = smoke_cfg(arch, vocab, **changes)
    want = one_device(cfg)
    out2 = run_ranks(2, tp_worker, (case, cfg, [(1, 2)]), tmp_path)
    out4 = run_ranks(4, tp_worker, (case, cfg, [(1, 4), (2, 2)]), tmp_path)
    for (d, m), out in (((1, 2), out2), ((1, 4), out4), ((2, 2), out4)):
        tag = f"{case}-{d}x{m}"
        sharded = model_sharded(param_shardings(want["params"], {"data": d, "model": m}, cfg))
        assert sharded, tag
        bad = forbidden_shapes(want["params"], sharded)
        rows = BATCH // d
        for r in range(d * m):
            got = torch.load(os.path.join(out, f"{tag}-rank{r}.pt"), weights_only=False)
            i = got["dp_index"]
            close(got["logits"], want["logits"][i * rows:(i + 1) * rows],
                  f"{tag} prefill logits rank {r}")
            for what in ("serve_gathers", "train_gathers"):
                hits = [s for s in got[what] if tuple(s) in bad]
                assert not hits, f"{tag} rank {r}: a model-sharded leaf gathered ({what}) {hits}"
            assert got["model_calls"], f"{tag}: no collective over model"
            for path, spread in got["spread"].items():
                assert spread == 0.0, f"{tag} rank {r}: grad of {path} differs by {spread}"
            if d == 1:
                assert set(got["flops"]) <= sharded, tag
                for path in sharded:
                    n1 = want["flops"].get(path, 0)
                    assert got["flops"].get(path, 0) * m == n1, \
                        f"{tag} rank {r} {path}: {got['flops'].get(path, 0)} x {m} != {n1}"
        got = torch.load(os.path.join(out, f"{tag}.pt"), weights_only=False)
        for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
            close(a, b, f"{tag} decode step {i + 1} logits")
        close_tree(got["cache"], want["cache"], f"{tag} cache")
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= BOUND * abs(b), (tag, got["losses"], want["losses"])
        assert int(got["state"]["step"]) == int(want["state"]["step"])
        close_tree(got["state"]["params"], want["state"]["params"], f"{tag} params",
                   want["allowance"])
        close_tree(got["state"]["opt"]["m"], want["state"]["opt"]["m"], f"{tag} m")
        close_tree(got["state"]["opt"]["v"], want["state"]["opt"]["v"], f"{tag} v")
    assert sum(want["flops"].values()) > 0


# ---------------------------------------------------------- the reference
REF_CASES = {"yi-9b": ("yi-9b", 512, {"n_kv_heads": 2}),
             "mamba2-780m": ("mamba2-780m", 512, {})}


@pytest.fixture(scope="module")
def reference_prefill(tmp_path_factory):
    """The reference's (1, 4) jitted prefill on 4 forced host devices, its
    parameters (seed 0) saved by path: {case: (npz path, logits)}."""
    root = tmp_path_factory.mktemp("ref-tp")
    code = f"""
import json
from dataclasses import replace
import numpy as np
import jax
from repro.configs import REGISTRY
from jax.sharding import Mesh
from repro.distributed.sharding import batch_specs, param_shardings, use_mesh
from repro.models.model import build_params, demo_batch
from repro.train.train_step import make_prefill_step
out = {{}}
for name, (arch, vocab, changes) in {REF_CASES!r}.items():
    cfg = replace(REGISTRY[arch].smoke(), dtype="float32", vocab_size=vocab, **changes)
    params = build_params(cfg, seed=0)
    batch = demo_batch(cfg, {BATCH}, {SEQ}, kind="prefill", seed=1)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    with use_mesh(mesh):
        step = jax.jit(make_prefill_step(cfg, max_seq={SEQ}),
                       in_shardings=(param_shardings(params, mesh, cfg),
                                     batch_specs(batch, mesh)))
        logits, _ = step(params, batch)
    flat = {{"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}}
    npz = {str(root)!r} + "/" + name + ".npz"
    np.savez(npz, **flat)
    out[name] = [npz, np.asarray(logits).tolist()]
print(json.dumps(out))
"""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    raw = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: (p, torch.from_numpy(np.asarray(v, np.float32))) for k, (p, v) in raw.items()}


def test_tensor_parallel_prefill_is_the_references(reference_prefill, tmp_path):
    cases = []
    for name, (arch, vocab, changes) in REF_CASES.items():
        cases.append((name, smoke_cfg(arch, vocab, **changes), reference_prefill[name][0]))
    out = run_ranks(4, tp_prefill_worker, (cases, (1, 4)), tmp_path)
    for name, _, _ in cases:
        got = torch.load(os.path.join(out, f"{name}-ref-prefill.pt"))
        close(got, reference_prefill[name][1], f"{name} (1, 4) prefill vs the reference")
