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
