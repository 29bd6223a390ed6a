"""Spawned gloo ranks for the port's distributed tests (imports no JAX).

:func:`run_ranks` starts ``world`` processes (the ``spawn`` method) that
meet through a ``FileStore`` under the test's temporary directory, never a
fixed port, so tests under ``pytest -n`` do not collide. Each rank runs
``target(rank, world, out_dir, *args)`` inside its process group; a rank
that fails writes its traceback, and a spawn that does not end within its
timeout is killed and fails its test. Rank 0's results travel back as
``torch.save`` files in ``out_dir``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from dataclasses import replace

import torch

JOIN_S = 240.0


def _entry(rank, world, store_path, out_dir, target, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            target(rank, world, out_dir, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(world: int, target, args: tuple, tmp_dir, timeout: float = JOIN_S) -> str:
    """Run ``target`` on ``world`` gloo ranks; return ``out_dir``."""
    out_dir = os.path.join(str(tmp_dir), f"ranks-{world}-{target.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    for name in os.listdir(out_dir):  # a FileStore is one rendezvous only
        os.remove(os.path.join(out_dir, name))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, store, out_dir, target, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        errors = [open(os.path.join(out_dir, n)).read()
                  for n in sorted(os.listdir(out_dir)) if n.startswith("error-")]
        assert not hung, f"ranks {hung} still running after {timeout} s; {errors[:1]}"
        assert not errors, errors[0]
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return out_dir


# --------------------------------------------------------------- compress
def compress_worker(rank, world, out_dir, cases):
    """For each case ``(name, trees)``: ``compressed_pmean`` over a
    ``(world,)`` ``"pod"`` mesh of rank ``rank``'s tree (``trees[rank]``,
    numpy arrays), twice (the second call carries the first's error
    feedback), the first under the collective counter; every rank saves its
    means, feedbacks and counts."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.compress import compressed_pmean, init_error_feedback

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    for name, trees in cases:
        tree = {k: torch.from_numpy(v) for k, v in trees[rank].items()}
        ef = init_error_feedback(tree)
        with CollectiveCounter() as cc:
            mean, ef1 = compressed_pmean(tree, ef, mesh, axis="pod")
        mean2, ef2 = compressed_pmean(tree, ef1, mesh, axis="pod")
        torch.save({"mean": mean, "ef": ef1, "mean2": mean2, "ef2": ef2,
                    "calls": dict(cc.calls), "bytes": dict(cc.bytes)},
                   os.path.join(out_dir, f"{name}-rank{rank}.pt"))


# ------------------------------------------------------------ mesh training
STEP0 = 50  # the schedule's factor is 0 at step 0
BATCH, SEQ = 4, 16


def smoke_cfg(arch: str, vocab: int, **changes):
    """The smoke config in fp32 with ``vocab`` ids (and ``changes``)."""
    from repro_torch.configs import REGISTRY

    return replace(REGISTRY[arch].smoke(), dtype="float32", vocab_size=vocab,
                   **changes)


def initial_state(cfg, opt):
    from repro_torch.train.state import make_state

    state = make_state(cfg, opt, seed=0, device="cpu")
    state["step"].fill_(STEP0)
    return state


def batches(cfg, steps: int) -> list[dict]:
    from repro_torch.models.model import demo_batch

    return [demo_batch(cfg, BATCH, SEQ, kind="train", seed=s, device="cpu")
            for s in range(steps)]


def train_worker(rank, world, out_dir, cfg, jobs):
    """For each job ``(name, (data, model), remat, q8, fsdp, steps,
    count)``: the smoke config's state placed on that mesh by
    ``state_shardings`` and trained ``steps`` steps; rank 0 saves the
    losses and the whole state (gathered) after each step, and with ``count`` the
    collectives of the first step (the same hook the dry-run reads)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import make_mesh_train_step
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.tree import tree_map

    for name, shape, remat, q8, fsdp, steps, count in jobs:
        opt = AdamWConfig(quantized_moments=q8)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        sh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg, fsdp)
        state = place_tree(initial_state(cfg, opt), sh)
        step = make_mesh_train_step(cfg, opt, mesh, sh, remat=remat)
        losses, counted, wholes = [], None, []
        for i, b in enumerate(batches(cfg, steps)):
            if count and i == 0:
                with CollectiveCounter() as cc:
                    state, metrics = step(state, b)
                counted = {"calls": dict(cc.calls), "bytes": dict(cc.bytes)}
            else:
                state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            wholes.append(tree_map(lambda t: t.full_tensor().clone(), state))
        if rank == 0:
            torch.save({"losses": losses, "states": wholes, "counted": counted},
                       os.path.join(out_dir, f"{name}.pt"))
        ckpt_dir = os.path.join(out_dir, f"ckpt-{name}")
        ckpt.save(state, 1, ckpt_dir)  # every rank gathers, rank 0 writes


def restore_worker(rank, world, out_dir, cfg, jobs):
    """For each job ``(name, (data, model), directory, q8)``: the
    checkpoint in ``directory`` restored onto that mesh with
    ``shardings=``; rank 0 saves the whole state gathered back."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import ckpt
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.tree import leaves, tree_map

    for name, shape, directory, q8 in jobs:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        abstract = make_abstract_state(cfg, AdamWConfig(quantized_moments=q8))
        sh = state_shardings(abstract, mesh, cfg)
        state, step = ckpt.restore(directory, abstract, device="cpu", shardings=sh)
        assert all(hasattr(t, "full_tensor") for t in leaves(state))
        whole = tree_map(lambda t: t.full_tensor(), state)
        if rank == 0:
            torch.save({"state": whole, "step": step,
                        "local_numel": sum(t.to_local().numel() for t in leaves(state))},
                       os.path.join(out_dir, f"{name}.pt"))


def train_then_restore(rank, world, out_dir, cfg, train_jobs, restore_jobs):
    """:func:`train_worker`'s jobs, then :func:`restore_worker`'s."""
    train_worker(rank, world, out_dir, cfg, train_jobs)
    restore_worker(rank, world, out_dir, cfg, restore_jobs)


def serve_worker(rank, world, out_dir, jobs):
    """For each job ``(name, cfg, (data, model), fsdp)``: the parameters
    placed by ``param_shardings``; the mesh prefill step of a (4, 16) batch
    (each rank its share of the rows) and the mesh decode step of one token
    against the one-device prefill's cache placed by ``cache_specs_tree``.
    Every rank saves its prefill logits and data index; rank 0 the decode's
    logits and its cache gathered."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import (cache_specs_tree, dp_axes,
                                                  param_shardings, place_tree)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import build_params, demo_batch, serve_prefill
    from repro_torch.train.mesh_step import (make_mesh_decode_step,
                                             make_mesh_prefill_step)
    from repro_torch.tree import tree_map

    for name, cfg, shape, fsdp in jobs:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        params = build_params(cfg, seed=0, device="cpu")
        sh = param_shardings(params, mesh, cfg, fsdp)
        placed = place_tree(params, sh)
        batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
        logits, _ = make_mesh_prefill_step(cfg, mesh, max_seq=SEQ + 4)(placed, batch)
        _, cache = serve_prefill(params, batch, cfg, max_seq=SEQ + 4)
        c_sh = cache_specs_tree(cache, mesh, cfg, ShapeConfig("s", SEQ + 4, BATCH, "decode"))
        placed_cache = place_tree(cache, c_sh)
        token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2, device="cpu")
        d_logits, new_cache = make_mesh_decode_step(cfg, mesh)(placed, placed_cache, token)
        coord = mesh.get_coordinate()
        names = list(mesh.mesh_dim_names)
        dp = [names.index(a) for a in dp_axes(mesh)]
        torch.save({"logits": logits, "dp_index": coord[dp[0]]},
                   os.path.join(out_dir, f"{name}-prefill-rank{rank}.pt"))
        whole = tree_map(lambda t: t.full_tensor().clone(), new_cache)
        if rank == 0:
            torch.save({"logits": d_logits, "cache": whole},
                       os.path.join(out_dir, f"{name}-decode.pt"))


# ------------------------------------------------ tensor-parallel compute
DECODE_STEPS = 4


class WeightFlops:
    """``with WeightFlops(weights) as wf: ...``: the flops of every op that
    ``FlopCounterMode`` counts (its formula table), summed by the leaf whose
    storage one of its operands views (``weights``: storage pointer ->
    leaf path) into ``wf.flops``."""

    def __init__(self, weights: dict):
        from collections import Counter

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        owner = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    hit = {weights.get(t.untyped_storage().data_ptr())
                           for t in args if isinstance(t, torch.Tensor)} - {None}
                    if hit:
                        n = formula(*args, **(kwargs or {}), out_val=out)
                        for k in hit:
                            owner.flops[k] += n
                return out

        self.flops = Counter()
        self._mode = Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def model_sharded(shardings) -> set:
    """The paths of the leaves a sharding tree splits over ``model``."""
    from repro_torch.tree import leaves_with_paths

    return {p for p, s in leaves_with_paths(shardings)
            if any("model" in (e if isinstance(e, tuple) else (e,)) for e in s.spec)}


def serve_steps(cfg, mesh, placed, params_sharded=(), count_flops=False):
    """The mesh prefill of a (BATCH, SEQ) batch and DECODE_STEPS decode steps
    of fixed tokens against its cache, under the collective counter (and
    the flop counter by ``params_sharded`` leaf); returns the prefill
    logits, the decode logits, the cache, the counter and the flops."""
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.models.model import demo_batch
    from repro_torch.train.mesh_step import (local, make_mesh_decode_step,
                                             make_mesh_prefill_step)
    from repro_torch.tree import leaves_with_paths

    weights = {local(t).untyped_storage().data_ptr(): p
               for p, t in leaves_with_paths(placed) if p in params_sharded}
    batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
    prefill = make_mesh_prefill_step(cfg, mesh, max_seq=SEQ + DECODE_STEPS)
    decode = make_mesh_decode_step(cfg, mesh)
    with CollectiveCounter() as cc, WeightFlops(weights if count_flops else {}) as wf:
        logits, cache = prefill(placed, batch)
        steps = []
        for i in range(DECODE_STEPS):
            token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2 + i, device="cpu")
            d_logits, cache = decode(placed, cache, token)
            steps.append(d_logits)
    return logits, steps, cache, cc, dict(wf.flops)


def tp_worker(rank, world, out_dir, name, cfg, shapes):
    """For each ``(data, model)`` in ``shapes``: the parameters placed by
    ``param_shardings``, :func:`serve_steps` with the flops of every
    ``model``-sharded leaf counted, the gradients of one batch (each
    replicated leaf's largest difference from the other ranks of its
    ``model`` group), then two train steps of the state placed by
    ``state_shardings``, under the collective counter. Every rank saves its
    prefill logits, data index, flops, gathers over ``model`` and gradient
    differences; rank 0 the decode logits, the cache, the losses and the
    state, gathered."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import (dp_axes, param_shardings,
                                                  place_tree, use_mesh)
    from repro_torch.models import layers
    from repro_torch.models.model import build_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import (_dp_groups, _gather_data, _share,
                                             make_mesh_train_step)
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves_with_paths, tree_map

    for shape in shapes:
        tag = f"{name}-{shape[0]}x{shape[1]}"
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")
        params = build_params(cfg, seed=0, device="cpu")
        sh = param_shardings(params, mesh, cfg)
        placed = place_tree(params, sh)
        sharded = model_sharded(sh)
        logits, steps, cache, cc, flops = serve_steps(cfg, mesh, placed, sharded,
                                                      count_flops=True)
        whole_cache = tree_map(lambda t: t.full_tensor().clone(), cache)

        opt = AdamWConfig()
        ssh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg)
        state = place_tree(initial_state(cfg, opt), ssh)
        first = batches(cfg, STEPS_TP)[0]
        share, split = _share(first, mesh)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            _, grads = loss_and_grads(tree_map(_gather_data, state["params"]), share, cfg)
        spread = {}
        for path, g in leaves_with_paths(grads):
            if path not in sharded:
                every = [torch.empty_like(g) for _ in range(dist.get_world_size(group))]
                dist.all_gather(every, g.contiguous(), group=group)
                spread[path] = max(float((e - g).abs().max()) for e in every)
        step = make_mesh_train_step(cfg, opt, mesh, ssh)
        losses = []
        with CollectiveCounter() as tc:
            for b in batches(cfg, STEPS_TP):
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
        whole_state = tree_map(lambda t: t.full_tensor().clone(), state)
        coord = mesh.get_coordinate()
        names = list(mesh.mesh_dim_names)
        mname = group.group_name
        torch.save({"logits": logits, "dp_index": coord[names.index(dp_axes(mesh)[0])],
                    "flops": flops, "spread": spread,
                    "serve_gathers": [s for g, s in cc.gathered if g == mname],
                    "train_gathers": [s for g, s in tc.gathered if g == mname],
                    "model_calls": {k: n for (g, k), n in {**cc.by_group, **tc.by_group}.items()
                                    if g == mname}},
                   os.path.join(out_dir, f"{tag}-rank{rank}.pt"))
        if rank == 0:
            torch.save({"steps": steps, "cache": whole_cache, "losses": losses,
                        "state": whole_state}, os.path.join(out_dir, f"{tag}.pt"))


STEPS_TP = 2


def tp_prefill_worker(rank, world, out_dir, cases, shape):
    """For each ``(name, cfg, npz)``: the reference's parameters (``npz``
    of its leaves by path) converted, placed on a ``(data, model)`` mesh
    and prefilled as :func:`serve_steps` does; rank 0 saves the logits."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import params_from_reference
    from repro_torch.distributed.sharding import param_shardings, place_tree
    from repro_torch.models.model import demo_batch
    from repro_torch.train.mesh_step import make_mesh_prefill_step

    for name, cfg, npz in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        tree: dict = {}
        with np.load(npz) as f:
            for key in f.files:
                node = tree
                *parents, leaf = key.split("/")
                for k in parents:
                    node = node.setdefault(k, {})
                node[leaf] = f[key]
        params = params_from_reference(tree, device="cpu")
        placed = place_tree(params, param_shardings(params, mesh, cfg))
        batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
        logits, _ = make_mesh_prefill_step(cfg, mesh, max_seq=SEQ)(placed, batch)
        if rank == 0:
            torch.save(logits, os.path.join(out_dir, f"{name}-ref-prefill.pt"))
