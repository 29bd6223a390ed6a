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

import math
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
        assert not errors, "\n".join(errors)
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


def batches(cfg, steps: int, batch: int = BATCH) -> list[dict]:
    from repro_torch.models.model import demo_batch

    return [demo_batch(cfg, batch, SEQ, kind="train", seed=s, device="cpu")
            for s in range(steps)]


def host_mesh(shape: tuple):
    """A ``(data, model)`` or ``(pod, data, model)`` mesh of gloo ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def share_index(mesh) -> int:
    """The rank's share of a batch split over the data axes (outer axis
    major, as ``batch_specs`` places it)."""
    from repro_torch.distributed.sharding import dp_axes

    coord, names = mesh.get_coordinate(), list(mesh.mesh_dim_names)
    index = 0
    for a in dp_axes(mesh):
        index = index * mesh.shape[names.index(a)] + coord[names.index(a)]
    return index


def axis_log(cc, mesh) -> list:
    """A collective counter's calls in order, ``(mesh axis, kind, bytes)``."""
    axis = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    return [(axis.get(g, g), k, n) for g, k, n in cc.log]


def by_axis(cc, mesh) -> dict:
    """A collective counter's calls by ``(mesh axis, kind)`` and its
    all-gathers' result shapes by axis, for the axes of ``mesh``."""
    axis = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    return {"calls": {(axis.get(g, g), k): n for (g, k), n in cc.by_group.items()},
            "gathered": [(axis.get(g, g), s) for g, s in cc.gathered]}


def train_worker(rank, world, out_dir, cfg, jobs):
    """For each job ``(name, (data, model), remat, q8, fsdp, steps,
    count)``: the smoke config's state placed on that mesh by
    ``state_shardings`` and trained ``steps`` steps; rank 0 saves the
    losses and the whole state (gathered) after each step, and with ``count`` the
    collectives of the first step (the same hook the dry-run reads)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import make_mesh_train_step
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.tree import tree_map

    for name, shape, remat, q8, fsdp, steps, count in jobs:
        opt = AdamWConfig(quantized_moments=q8)
        mesh = host_mesh(shape)
        sh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg, fsdp)
        state = place_tree(initial_state(cfg, opt), sh)
        step = make_mesh_train_step(cfg, opt, mesh, sh, remat=remat)
        losses, counted, wholes = [], None, []
        for i, b in enumerate(batches(cfg, steps)):
            if count and i == 0:
                with CollectiveCounter() as cc:
                    state, metrics = step(state, b)
                counted = {"calls": dict(cc.calls), "bytes": dict(cc.bytes),
                           "log": axis_log(cc, mesh)}
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
    against the one-device prefill's cache placed by ``cache_specs_tree``
    (its batch rows over ``data``; a batch smaller than the data axes
    would split its sequence instead, :func:`seq_cache_worker`). Every rank
    saves its prefill logits and data index; rank 0 the decode's logits
    and its cache gathered."""
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


SEQ_MAX, SEQ_STEPS = 20, 6  # the batch-1 cache's slots and decode steps


def load_reference_params(npz: str) -> dict:
    """The port's parameters from the reference's leaves saved by path in
    ``npz``."""
    import numpy as np

    from repro_torch.convert import params_from_reference

    tree: dict = {}
    with np.load(npz) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return params_from_reference(tree, device="cpu")


def seq_cache_worker(rank, world, out_dir, jobs):
    """For each job ``(name, cfg, (data, model), prompt, npz)``: the
    parameters (the reference's in ``npz``, converted; the port's from seed
    0 where ``npz`` is None) placed by
    ``param_shardings``, the mesh prefill of a batch of one ``prompt``-token
    row into ``SEQ_MAX`` slots (a batch smaller than the data axes, so
    ``cache_specs_tree`` splits the KV caches' sequence over ``data`` where
    it divides) and ``SEQ_STEPS`` decode steps, each under its own
    collective counter. Every rank saves its logits, each decode step's
    collectives by mesh axis (:func:`by_axis`) and kind, its cache leaves'
    local shapes and which leaves are split; rank 0 also the cache
    gathered whole after the steps."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import param_shardings, place_tree
    from repro_torch.models.model import build_params, demo_batch
    from repro_torch.train.mesh_step import (_seq_split, local, make_mesh_decode_step,
                                             make_mesh_prefill_step)
    from repro_torch.tree import leaves_with_paths, tree_map

    for name, cfg, shape, prompt, npz in jobs:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        params = (load_reference_params(npz) if npz
                  else build_params(cfg, seed=0, device="cpu"))
        placed = place_tree(params, param_shardings(params, mesh, cfg))
        batch = demo_batch(cfg, 1, prompt, kind="prefill", seed=1, device="cpu")
        logits, cache = make_mesh_prefill_step(cfg, mesh, max_seq=SEQ_MAX)(placed, batch)
        decode = make_mesh_decode_step(cfg, mesh)
        steps, counts = [], []
        for i in range(SEQ_STEPS):
            token = demo_batch(cfg, 1, 1, kind="decode", seed=2 + i, device="cpu")
            with CollectiveCounter() as cc:
                d_logits, cache = decode(placed, cache, token)
            counts.append({**by_axis(cc, mesh), "kinds": dict(cc.calls),
                           "bytes": dict(cc.bytes)})
            steps.append(d_logits)
        torch.save({"logits": logits, "steps": steps, "counts": counts,
                    "split": _seq_split(mesh, cache),
                    "local": {p: tuple(local(t).shape) for p, t in leaves_with_paths(cache)}},
                   os.path.join(out_dir, f"{name}-rank{rank}.pt"))
        whole = tree_map(lambda t: t.full_tensor().clone(), cache)
        if rank == 0:
            torch.save(whole, os.path.join(out_dir, f"{name}-cache.pt"))


def attend_split_worker(rank, world, out_dir, cases):
    """For each case ``(name, S, pos)``: a bf16 query of one token (2, 8,
    64) against a bf16 cache of ``S`` slots of 2 KV heads, drawn from the
    case's index on every rank, attended whole (``attend_cache`` as one
    device runs it) and on the rank's S/world slots with its softmax
    combined over the world group, the slots past ``pos`` masked in both.
    Every rank saves both outputs."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.models.layers import attend_cache

    for i, (name, S, pos) in enumerate(cases):
        rng = np.random.default_rng(i)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
                   for shape in ((2, 8, 64), (2, S, 2, 64), (2, S, 2, 64)))
        valid = torch.arange(S) <= pos
        whole = attend_cache(q, k, v, None, valid=valid)
        mine = slice(rank * S // world, (rank + 1) * S // world)
        split = attend_cache(q, k[:, mine], v[:, mine], None, valid=valid[mine],
                             seq=dist.group.WORLD)
        torch.save({"whole": whole, "split": split},
                   os.path.join(out_dir, f"{name}-rank{rank}.pt"))


def one_device_run(cfg, steps: int, microbatches: int = 1, batch: int = BATCH,
                   bound: float = 1e-4) -> list[dict]:
    """The one-device run's loss and state after each of ``steps`` fp32
    steps, and each parameter's allowance: lr x the change of the Adam step
    m/(sqrt(v) + eps) for a gradient change of ``bound`` of the leaf's
    largest gradient, summed over the steps (Adam divides each entry by its
    own magnitude, so where the gradient nearly cancels the step follows
    its last digits, which a mesh's order of sums sets apart)."""
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule, param_nodes
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    opt = AdamWConfig()
    state = initial_state(cfg, opt)
    step = make_train_step(cfg, opt, microbatches=microbatches)
    out, allowance = [], {}
    for b in batches(cfg, steps, batch):
        n = batch // microbatches
        grads = None
        for i in range(microbatches):
            _, g = loss_and_grads(state["params"], {k: v[i * n:(i + 1) * n]
                                                    for k, v in b.items()}, cfg)
            grads = g if grads is None else tree_map(torch.add, grads, g)
        grads = tree_map(lambda g: g.double() / microbatches, grads)
        norm = sum(float(g.square().sum()) for g in leaves(grads)) ** 0.5
        clip = min(1.0, opt.grad_clip / (norm + 1e-9))
        count = int(state["opt"]["count"]) + 1
        bc1, bc2 = 1 - opt.b1 ** count, 1 - opt.b2 ** count
        lr = opt.lr * float(cosine_schedule(state["step"]))
        nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"], grads)
        for (path, _), (_, m, v, g) in zip(leaves_with_paths(state["params"]), nodes):
            g, m, v = g * clip, m.double(), v.double()

            def adam(x, m=m, v=v):
                return ((opt.b1 * m + (1 - opt.b1) * x) / bc1) / (
                    torch.sqrt((opt.b2 * v + (1 - opt.b2) * x * x) / bc2) + opt.eps)

            d = bound * float(g.abs().max())
            more = lr * torch.maximum((adam(g + d) - adam(g)).abs(), (adam(g - d) - adam(g)).abs())
            allowance[path] = allowance[path] + more if path in allowance else more
        state, metrics = step(state, b)
        out.append({"loss": float(metrics["loss"]), "state": tree_map(torch.clone, state),
                    "allowance": dict(allowance)})
    return out


def fsdp_train_worker(rank, world, out_dir, cfg, jobs, bound: float = 1e-4):
    """For each job ``(name, (data, model), remat, microbatches, rows)``:
    the state placed by ``state_shardings`` with FSDP and trained two steps
    of ``rows``-row batches, the first under the collective counter; after
    each step every rank holds its shard of every leaf to the same shard of
    the one-device run's (:func:`one_device_run`, which every rank computes
    itself, so nothing whole travels): the largest difference and its bound
    (``bound`` of the leaf's largest value, a parameter's beyond its
    allowance). Every rank saves its differences, the losses, and rank 0
    also the first step's collectives by mesh axis (:func:`by_axis`)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import local, make_mesh_train_step
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.tree import leaves_with_paths

    opt = AdamWConfig()
    runs: dict = {}
    for name, shape, remat, microbatches, rows in jobs:
        if (microbatches, rows) not in runs:
            runs[microbatches, rows] = one_device_run(cfg, 2, microbatches, rows, bound)
        want = runs[microbatches, rows]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        sh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg, fsdp=True)
        specs = dict(leaves_with_paths(sh))
        state = place_tree(initial_state(cfg, opt), sh)
        step = make_mesh_train_step(cfg, opt, mesh, sh, remat=remat, microbatches=microbatches)
        losses, diffs = [], []
        for i, b in enumerate(batches(cfg, len(want), rows)):
            if i == 0:
                with CollectiveCounter() as cc:
                    state, metrics = step(state, b)
                counted = by_axis(cc, mesh)
            else:
                state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            allow, mine = want[i]["allowance"], dict(leaves_with_paths(state))
            for path, whole in leaves_with_paths(want[i]["state"]):
                part = local(specs[path].place(whole))
                diff = (local(mine[path]).double() - part.double()).abs()
                if path.startswith("params/"):
                    key = path.removeprefix("params/")
                    diff = diff - local(specs[path].place(allow[key])) * (1 + 1e-6)
                diffs.append((i + 1, path, float(diff.max()) if diff.numel() else 0.0,
                              bound * max(float(whole.double().abs().max()), 1e-30)))
        torch.save({"losses": losses, "want": [w["loss"] for w in want], "diffs": diffs,
                    "counted": counted if rank == 0 else None},
                   os.path.join(out_dir, f"{name}-rank{rank}.pt"))


def fsdp_serve_worker(rank, world, out_dir, jobs):
    """For each job ``(name, cfg, (data, model))``: the parameters placed
    by ``param_shardings`` with FSDP, the mesh prefill of a (BATCH, SEQ)
    batch and DECODE_STEPS decode steps of fixed tokens against its cache,
    each call under its own collective counter. Every rank saves its
    prefill logits and data index; rank 0 the decode logits and the
    calls' counts by mesh axis (:func:`by_axis`)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import dp_axes, param_shardings, place_tree
    from repro_torch.models.model import build_params, demo_batch
    from repro_torch.train.mesh_step import make_mesh_decode_step, make_mesh_prefill_step

    for name, cfg, shape in jobs:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        params = build_params(cfg, seed=0, device="cpu")
        placed = place_tree(params, param_shardings(params, mesh, cfg, fsdp=True))
        batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
        decode = make_mesh_decode_step(cfg, mesh)
        counts = []
        with CollectiveCounter() as cc:
            logits, cache = make_mesh_prefill_step(cfg, mesh, max_seq=SEQ + DECODE_STEPS)(
                placed, batch)
        counts.append(by_axis(cc, mesh))
        steps = []
        for i in range(DECODE_STEPS):
            token = demo_batch(cfg, BATCH, 1, kind="decode", seed=2 + i, device="cpu")
            with CollectiveCounter() as cc:
                d_logits, cache = decode(placed, cache, token)
            counts.append(by_axis(cc, mesh))
            steps.append(d_logits)
        coord = mesh.get_coordinate()
        dp = list(mesh.mesh_dim_names).index(dp_axes(mesh)[0])
        torch.save({"logits": logits, "dp_index": coord[dp]},
                   os.path.join(out_dir, f"{name}-prefill-rank{rank}.pt"))
        if rank == 0:
            torch.save({"steps": steps, "counts": counts},
                       os.path.join(out_dir, f"{name}-decode.pt"))


def fsdp_grad_worker(rank, world, out_dir, jobs):
    """For each job ``(name, (data, model), dtype, split)``: a (6, 8)
    leaf's FSDP shard (its columns over ``data``) gathered whole by
    ``tp.gather_data``, and the gradient reaching the shard from a loss
    whose gradient at the gathered leaf is this rank's own weights (drawn
    alike on every rank, one slice a rank). Rank 0 saves the weights;
    every rank its gradient, its data index and whether the gather gave
    the whole leaf."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tp

    for name, shape, dtype, split in jobs:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((6, 8), generator=gen).to(dtype)
        # 8-bit integers times 2^-4..2^4: exact in bf16, their sums exact in
        # fp32 in any order, and a sum in bf16 rounds
        w = torch.randint(-128, 128, (world, 6, 8), generator=gen).float() \
            * 2.0 ** torch.randint(-4, 5, (world, 6, 8), generator=gen)
        i = mesh.get_local_rank("data")
        shard = x.chunk(shape[0], 1)[i].clone().requires_grad_()
        whole = tp.gather_data(shard, 1, mesh.get_group("data"), [] if split else None)
        (grad,) = torch.autograd.grad((whole.float() * w[rank]).sum(), shard)
        torch.save({"grad": grad, "data": i, "gathered": torch.equal(whole, x)},
                   os.path.join(out_dir, f"{name}-rank{rank}.pt"))
        if rank == 0:
            torch.save(w, os.path.join(out_dir, f"{name}-w.pt"))


# ------------------------------------------------ tensor-parallel compute
DECODE_STEPS = 4


class WeightFlops:
    """``with WeightFlops(weights) as wf: ...``: the flops of every op that
    ``FlopCounterMode`` counts (its formula table), summed by the leaf whose
    storage one of its operands views (``weights``: storage pointer ->
    leaf path) into ``wf.flops``, and those of the ops none of whose
    operands is a leaf (attention's scores and PV products, in a model
    without SSM layers) into ``wf.other``."""

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
                    n = formula(*args, **(kwargs or {}), out_val=out)
                    for k in hit:
                        owner.flops[k] += n
                    if not hit:
                        owner.other += n
                return out

        self.flops = Counter()
        self.other = 0
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
    the flop counter by leaf); returns the prefill logits, the decode
    logits, the cache, the counter, the flops of the ``params_sharded``
    leaves and those of the ops that read no leaf."""
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.models.model import demo_batch
    from repro_torch.train.mesh_step import (local, make_mesh_decode_step,
                                             make_mesh_prefill_step)
    from repro_torch.tree import leaves_with_paths

    weights = {local(t).untyped_storage().data_ptr(): p
               for p, t in leaves_with_paths(placed)}
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
    flops = {p: n for p, n in wf.flops.items() if p in params_sharded}
    return logits, steps, cache, cc, flops, wf.other


def tp_worker(rank, world, out_dir, name, cfg, shapes):
    """For each ``(data, model)`` or ``(pod, data, model)`` in ``shapes``:
    the parameters placed by ``param_shardings``, :func:`serve_steps` with the flops of every
    ``model``-sharded leaf counted, the gradients of one batch (each
    replicated leaf's largest difference from the other ranks of its
    ``model`` group), then two train steps of the state placed by
    ``state_shardings``, under the collective counter. Every rank saves its
    prefill logits, share index, flops, gathers over ``model`` and gradient
    differences; rank 0 the decode logits, the cache, the losses and the
    state, gathered."""
    import torch.distributed as dist

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import param_shardings, place_tree, use_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import (_dp_groups, _share, local,
                                             make_mesh_train_step)
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves_with_paths, tree_map

    for shape in shapes:
        tag = f"{name}-{'x'.join(map(str, shape))}"
        mesh = host_mesh(shape)
        group = mesh.get_group("model")
        params = build_params(cfg, seed=0, device="cpu")
        sh = param_shardings(params, mesh, cfg)
        placed = place_tree(params, sh)
        sharded = model_sharded(sh)
        logits, steps, cache, cc, flops, other = serve_steps(cfg, mesh, placed, sharded,
                                                             count_flops=True)
        whole_cache = tree_map(lambda t: t.full_tensor().clone(), cache)

        opt = AdamWConfig()
        ssh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg)
        state = place_tree(initial_state(cfg, opt), ssh)
        first = batches(cfg, STEPS_TP)[0]
        share, split = _share(first, mesh)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            _, grads = loss_and_grads(tree_map(local, state["params"]), share, cfg)
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
        mname = group.group_name
        torch.save({"logits": logits, "dp_index": share_index(mesh),
                    "flops": flops, "other_flops": other, "spread": spread,
                    "serve_gathers": [s for g, s in cc.gathered if g == mname],
                    "train_gathers": [s for g, s in tc.gathered if g == mname],
                    "model_calls": {k: n for (g, k), n in {**cc.by_group, **tc.by_group}.items()
                                    if g == mname}},
                   os.path.join(out_dir, f"{tag}-rank{rank}.pt"))
        if rank == 0:
            torch.save({"steps": steps, "cache": whole_cache, "losses": losses,
                        "state": whole_state}, os.path.join(out_dir, f"{tag}.pt"))


STEPS_TP = 2


def tp_prefill_worker(rank, world, out_dir, cases):
    """For each ``(name, cfg, npz, mesh shape)``: the reference's
    parameters (``npz`` of its leaves by path) converted, placed on that
    mesh and prefilled as :func:`serve_steps` does; every rank saves its
    logits (its data share's rows) and share index."""
    from repro_torch.distributed.sharding import param_shardings, place_tree
    from repro_torch.models.model import demo_batch
    from repro_torch.train.mesh_step import make_mesh_prefill_step

    for name, cfg, npz, shape in cases:
        mesh = host_mesh(shape)
        params = load_reference_params(npz)
        placed = place_tree(params, param_shardings(params, mesh, cfg))
        batch = demo_batch(cfg, BATCH, SEQ, kind="prefill", seed=1, device="cpu")
        logits, _ = make_mesh_prefill_step(cfg, mesh, max_seq=SEQ)(placed, batch)
        torch.save({"logits": logits, "dp_index": share_index(mesh)},
                   os.path.join(out_dir, f"{name}-ref-prefill-rank{rank}.pt"))


# ------------------------------------------------- the q8 update on a rank's rows
def q8_leaf_case(name: str, shape: tuple, seed: int) -> dict:
    """A q8 leaf's whole tensors, made from ``seed`` with numpy: the
    parameter, two steps' gradients and q8 moments that start from nonzero
    values (so the first step dequantizes them)."""
    import numpy as np

    from repro_torch.optim.adamw import quantize_q8

    rng = np.random.default_rng(seed)

    def draw(scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    return {"name": name, "param": draw(), "grads": [draw(), draw(3.0)],
            "m": quantize_q8(draw(0.01)), "v": quantize_q8(draw(0.01).square())}


#: the step scalars of the two updates: (clip, count, lr)
Q8_STEPS = [(0.75, 1, 3e-4), (1.0, 2, 2.5e-4)]


def q8_update_worker(rank, world, out_dir, cases):
    """For each case ``(mesh, chunk, leaves)``, ``mesh`` a ``(data, model)``
    or ``(pod, data, model)`` shape and ``chunk`` the positions
    ``q8_shard`` works on at once (None: its default), each leaf ``(name,
    shape, spec, seed)``: the leaf (:func:`q8_leaf_case`) placed by ``spec``
    and its q8 moments by ``state_shardings``' rule (rows over ``data``
    where they divide), updated twice by ``q8_shard.update_leaf`` from the
    rank's gradient (its FSDP shard where ``spec`` shards over ``data``,
    else its ``model`` shard), each update under the collective counter;
    the whole-leaf ``moment_step`` and ``apply_step`` run beside it on
    every rank. Every rank saves, per leaf and update, whether its parameter
    shard, ``q`` and ``scale`` rows and their dequantized fp32 moments equal
    the same shards of the whole-leaf update's bit for bit, the update's
    collectives by mesh axis (:func:`by_axis`), and how many positions it
    owns (``|W|``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.optim import q8_shard
    from repro_torch.optim.adamw import AdamWConfig, apply_step, dequantize_q8, moment_step

    opt = AdamWConfig(quantized_moments=True)
    default = q8_shard.CHUNK
    results = {}
    for shape, chunk, leaves in cases:
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        d = shape[-2]
        q8_shard.CHUNK = chunk or default
        for name, leaf_shape, spec, seed in leaves:
            case = q8_leaf_case(name, leaf_shape, seed)
            sh = NamedSharding(mesh, spec)
            rows = case["m"]["q"].shape[0]
            qs = NamedSharding(mesh, ("data" if rows % d == 0 else None, None))
            on_model = NamedSharding(mesh, tuple(None if e == "data" else e for e in spec))
            fsdp = d > 1 and "data" in spec
            p = sh.place(case["param"].clone())
            m = {k: qs.place(t.clone()) for k, t in case["m"].items()}
            v = {k: qs.place(t.clone()) for k, t in case["v"].items()}
            plan = q8_shard._Plan(p, m["q"])
            la, lb = plan.own(plan.i, plan.j)
            whole = {"p": case["param"].clone(),
                     "m": {k: t.clone() for k, t in case["m"].items()},
                     "v": {k: t.clone() for k, t in case["v"].items()}}
            out = []
            for (clip, count, lr), grad in zip(Q8_STEPS, case["grads"]):
                clip, lr = torch.tensor(clip), torch.tensor(lr)
                bc1 = torch.tensor(1.0 - opt.b1 ** count)
                bc2 = torch.tensor(1.0 - opt.b2 ** count)
                g = (sh if fsdp else on_model).place(grad)._local_tensor
                with CollectiveCounter() as cc:
                    q8_shard.update_leaf(p, g, m, v, clip, bc1, bc2, lr, opt)
                apply_step(whole["p"], moment_step(grad, whole["m"], whole["v"], leaf_shape,
                                                   clip, bc1, bc2, opt), lr, opt)
                same = {"param": torch.equal(p._local_tensor,
                                             sh.place(whole["p"])._local_tensor)}
                for k, node in (("m", m), ("v", v)):
                    mine = {x: node[x]._local_tensor for x in node}
                    want = {x: qs.place(whole[k][x])._local_tensor for x in node}
                    for x in node:
                        same[f"{k}/{x}"] = torch.equal(mine[x], want[x])
                    same[f"{k}/fp32"] = torch.equal(
                        dequantize_q8(mine, (mine["q"].numel(),)),
                        dequantize_q8(want, (want["q"].numel(),)))
                out.append({"same": same, "owned": lb - la, **by_axis(cc, mesh)})
            results[shape, chunk, name] = out
    q8_shard.CHUNK = default
    torch.save(results, os.path.join(out_dir, f"q8-rank{rank}.pt"))


def q8_train_worker(rank, world, out_dir, cfg):
    """The smoke config's state with q8 moments placed with FSDP on a (2, 2)
    mesh and trained one step under the collective counter; every rank
    saves its all-gathers by mesh axis (:func:`by_axis`)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.mesh_step import make_mesh_train_step
    from repro_torch.train.state import make_abstract_state, state_shardings

    opt = AdamWConfig(quantized_moments=True)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    sh = state_shardings(make_abstract_state(cfg, opt), mesh, cfg, fsdp=True)
    state = place_tree(initial_state(cfg, opt), sh)
    step = make_mesh_train_step(cfg, opt, mesh, sh)
    with CollectiveCounter() as cc:
        step(state, batches(cfg, 1)[0])
    torch.save(by_axis(cc, mesh), os.path.join(out_dir, f"q8-train-rank{rank}.pt"))


# ------------------------------------------------ the MoE capacity over data
def moe_case(cfg, batch: int, seq: int, seed: int) -> dict:
    """A MoE layer's whole parameters, input and output weights (the loss
    is the sum of the output times ``probe``), made from ``seed``: the
    parameters by ``init_moe`` on a generator, x and probe with numpy."""
    import numpy as np

    from repro_torch.models import layers

    dtype = getattr(torch, cfg.dtype)
    params = layers.init_moe(torch.Generator().manual_seed(seed), cfg, dtype)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, seq, cfg.d_model), np.float32)).to(dtype)
    probe = torch.from_numpy(rng.standard_normal((batch, seq, cfg.d_model), np.float32))
    return {"params": params, "x": x, "probe": probe}


def model_columns(params: dict, j: int, m: int) -> dict:
    """Model rank j's shard of a MoE layer whose experts do not divide over
    ``m``: every expert's hidden columns [j F/m, (j+1) F/m), the router
    whole."""
    F = params["w_gate"].shape[2]
    cols = slice(j * F // m, (j + 1) * F // m)
    return {"router": params["router"], "w_gate": params["w_gate"][:, :, cols],
            "w_up": params["w_up"][:, :, cols], "w_down": params["w_down"][:, cols, :]}


def moe_layer_worker(rank, world, out_dir, cases):
    """For each case ``(name, shape, cfg, batch, seq, seed)``: ``layers.moe``
    alone on a ``(data, model)`` or ``(pod, data, model)`` mesh under
    ``split_batch`` over the data axes, on the rank's share of the batch
    rows and its model rank's hidden columns (:func:`model_columns`) of
    :func:`moe_case`'s layer, forward and backward of the share's loss,
    under the collective counter and :class:`WeightFlops`. Every rank
    saves its output, share and model index, the gradients of its x share
    and of its parameter shard, the flops by leaf and the collectives
    ``(axis, kind, bytes)``."""
    from repro_torch.distributed.comm import CollectiveCounter
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import layers
    from repro_torch.train.mesh_step import _dp_groups

    for name, shape, cfg, batch, seq, seed in cases:
        mesh = host_mesh(shape)
        case = moe_case(cfg, batch, seq, seed)
        n = math.prod(shape[:-1])
        i, j = share_index(mesh), mesh.get_local_rank("model")
        rows = slice(i * batch // n, (i + 1) * batch // n)
        local = {k: t.clone().requires_grad_() for k, t in
                 model_columns(case["params"], j, shape[-1]).items()}
        x = case["x"][rows].clone().requires_grad_()
        weights = {t.untyped_storage().data_ptr(): k for k, t in local.items()}
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh)), \
                CollectiveCounter() as cc, WeightFlops(weights) as wf:
            out = layers.moe(local, x, cfg)
            (out.float() * case["probe"][rows]).sum().backward()
        torch.save({"out": out.detach(), "share": i, "model": j, "x_grad": x.grad,
                    "grads": {k: t.grad for k, t in local.items()},
                    "flops": dict(wf.flops), "log": axis_log(cc, mesh)},
                   os.path.join(out_dir, f"{name}-rank{rank}.pt"))


def bf16_serve_worker(rank, world, out_dir, cfg, shape):
    """A bf16 config's parameters placed on ``shape`` by ``param_shardings``,
    :func:`serve_steps` and the loss of one train batch on the rank's share
    (under ``split_batch``); every rank saves its prefill logits and share
    index, rank 0 the decode logits, the cache gathered and the loss
    averaged over the shares."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import param_shardings, place_tree, use_mesh
    from repro_torch.models import layers
    from repro_torch.models.model import build_params, loss_fn
    from repro_torch.train.mesh_step import _dp_groups, _share, local
    from repro_torch.tree import tree_map

    mesh = host_mesh(shape)
    params = build_params(cfg, seed=0, device="cpu")
    placed = place_tree(params, param_shardings(params, mesh, cfg))
    logits, steps, cache, _, _, _ = serve_steps(cfg, mesh, placed)
    whole = tree_map(lambda t: t.full_tensor().clone(), cache)
    share, split = _share(batches(cfg, 1)[0], mesh)
    assert split
    with torch.no_grad(), use_mesh(mesh), layers.split_batch(_dp_groups(mesh)):
        loss = loss_fn(tree_map(local, placed), share, cfg).float()
    for g in _dp_groups(mesh):
        dist.all_reduce(loss, group=g)
    torch.save({"logits": logits, "dp_index": share_index(mesh)},
               os.path.join(out_dir, f"bf16-rank{rank}.pt"))
    if rank == 0:
        torch.save({"steps": steps, "cache": whole, "loss": float(loss) / math.prod(shape[:-1])},
                   os.path.join(out_dir, "bf16.pt"))
