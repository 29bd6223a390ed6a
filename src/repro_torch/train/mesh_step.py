"""Training, prefill and decode on a ``DeviceMesh``: the state placed as
DTensor shards by the reference's rules, the steps data-parallel.

The train step (:func:`make_mesh_train_step`) on every rank:

1. all-gathers each parameter leaf from its placement (FSDP or TP shards);
2. takes the rank's share of the batch: the global batch (every rank holds
   it, since the data order is a function of the step) cut by
   :func:`~repro_torch.distributed.sharding.batch_specs`, microbatch by
   microbatch as the reference reshapes it;
3. computes the loss and its gradients on that share, the compute over
   ``model`` replicated (every rank of a ``model`` group computes the same
   thing; tensor-parallel compute is not ported yet). MoE layers route over
   the whole batch (:func:`~repro_torch.models.layers.split_batch`);
4. averages the gradients over the data axes straight into each moment
   leaf's placement (a reduce-scatter into the ZeRO shard, DTensor's
   ``Partial`` -> ``Shard``), and the loss over the same ranks;
5. clips by the global norm (one all-reduce of the leaves' sums of squares)
   and updates each rank's shards with AdamW; a moment shard finer than
   its parameter's placement updates that slice of the parameter, and the
   slices are all-gathered back into the parameter's placement. q8 moments
   are blocked 256 elements at a time along the flattened leaf and sharded
   by row, which does not follow the parameter's dims: their rows are
   all-gathered (int8 and scales), the leaf is updated whole, and each rank
   keeps its rows and its parameter shard.

Every share is the same size (``batch_specs`` splits only what divides), so
the mean of the ranks' token means is the one-device loss, and the step
gives the one-device step's values up to the order of its sums. On a
``(1, 1)`` mesh it issues no collective of DTensor's and gives the
one-device step's values exactly.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import batch_specs, dp_axes, mesh_shape, use_mesh
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import serve_decode, serve_prefill
from repro_torch.optim.adamw import (AdamWConfig, cosine_schedule, param_nodes,
                                     step_scalars, update_leaf)
from repro_torch.train.train_step import loss_and_grads
from repro_torch.tree import leaves, tree_map, unflatten


def full_tensor(dt) -> torch.Tensor:
    """A DTensor's whole value on every rank (an all-gather over the mesh
    dims it is sharded on; nothing for a replicated one)."""
    mesh = dt.device_mesh
    return dt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def local(dt) -> torch.Tensor:
    """The rank's shard of a DTensor, writable in place."""
    return dt._local_tensor


def _share(batch: dict, mesh) -> tuple[dict, bool]:
    """The rank's share of ``batch`` by ``batch_specs``, and whether the
    batch was split (its leading dim divides over the data axes)."""
    specs = batch_specs(batch, mesh)
    split = any(s.spec and s.spec[0] is not None for s in leaves(specs))
    return tree_map(lambda t, s: local(s.place(t)), batch, specs), split


def _dp_groups(mesh) -> list:
    return [mesh.get_group(a) for a in dp_axes(mesh)]


def _sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _replicas(mesh, placements) -> int:
    """Ranks holding each shard: the product of the replicated dims' sizes."""
    sizes = list(mesh_shape(mesh).values())
    return math.prod(s for s, p in zip(sizes, placements) if p.is_replicate())


def make_mesh_train_step(cfg: ArchConfig, opt: AdamWConfig, mesh, shardings: dict,
                         microbatches: int = 1, remat: bool = True,
                         schedule_total: int = 10_000):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a state
    placed by ``shardings`` (:func:`~repro_torch.train.state.state_shardings`
    on ``mesh``) and the global ``batch`` on this rank's device; the shards
    are written in place, and ``metrics`` holds the fp32 ``loss`` (the
    mean over the whole batch) and ``lr_scale`` as plain tensors."""
    p_sh = [s for (s,) in param_nodes(shardings["params"])]
    m_sh = [s for _, s in param_nodes(shardings["params"], shardings["opt"]["m"])]
    replicate = [Replicate()] * mesh.ndim
    names = list(mesh_shape(mesh))
    dp = dp_axes(mesh)

    def grads_of(full, batch):
        """The loss and gradients of the rank's share, summed over
        microbatches in fp32 as ``make_train_step`` does, and whether the
        batch was split."""
        if microbatches == 1:
            share, split = _share(batch, mesh)
            with layers.split_batch(_dp_groups(mesh) if split else []):
                loss, grads = loss_and_grads(full, share, cfg, remat)
            return loss, leaves(grads), split
        loss, acc, split = None, None, False
        for i in range(microbatches):
            def part(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"{microbatches} microbatches")
                n = b // microbatches
                return x[i * n : (i + 1) * n]

            share, split = _share({k: part(v) for k, v in batch.items()}, mesh)
            with layers.split_batch(_dp_groups(mesh) if split else []):
                loss_mb, g = loss_and_grads(full, share, cfg, remat)
            if acc is None:
                loss = torch.zeros((), dtype=torch.float32, device=loss_mb.device)
                acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                       for x in leaves(g)]
            loss = loss + loss_mb
            for a, x in zip(acc, leaves(g)):
                a.add_(x)
        return loss / microbatches, [a / microbatches for a in acc], split

    @torch.no_grad()
    def update(state, full, grads, split: bool):
        """Average ``grads`` into the moments' placements, clip by the
        global norm and update every rank's shards in place."""
        n = math.prod(mesh_shape(mesh)[a] for a in dp) if split else 1
        g_in = [Partial() if split and a in dp else Replicate() for a in names]
        reduced, sq = [], []
        for g, ms in zip(grads, m_sh):
            to = replicate if opt.quantized_moments else list(ms.placements())
            gd = DTensor.from_local(g.float() / n if n > 1 else g.float(), mesh,
                                    g_in, run_check=False).redistribute(mesh, to)
            reduced.append(local(gd))
            r = _replicas(mesh, to)
            s = torch.sum(torch.square(local(gd)))
            sq.append(s / r if r > 1 else s)
        sq = torch.stack(sq)
        dist.all_reduce(sq)  # each shard counted once over the world
        gnorm = torch.sqrt(sum(sq.unbind()))
        count = state["opt"]["count"] + 1
        lr_scale = cosine_schedule(local(state["step"]), total=schedule_total)
        scalars = step_scalars(local(count), gnorm, opt, lr_scale)
        nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"])
        for (p, m, v), f, g, ps, ms in zip(nodes, full, reduced, p_sh, m_sh):
            if opt.quantized_moments:
                # the leaf whole: its q8 rows gathered, updated, then cut
                mf = {k: full_tensor(t).clone() for k, t in m.items()}
                vf = {k: full_tensor(t).clone() for k, t in v.items()}
                pf = f.clone()
                update_leaf(pf, g, mf, vf, *scalars, opt)
                local(p).copy_(local(ps.place(pf)))
                for node, whole in ((m, mf), (v, vf)):
                    for k in node:  # m and v share their rules
                        local(node[k]).copy_(local(ms[k].place(whole[k])))
                continue
            fine = ms.placements()
            pm = p.redistribute(mesh, list(fine)) if fine != ps.placements() else p
            pl = local(pm).clone() if pm is not p else local(p)
            update_leaf(pl, g, local(m), local(v), *scalars, opt)
            if pm is not p:
                back = DTensor.from_local(pl, mesh, list(fine), run_check=False)
                local(p).copy_(local(back.redistribute(mesh, list(ps.placements()))))
        return count, lr_scale

    def train_step(state, batch):
        full = [full_tensor(p) for p in leaves(state["params"])]
        with use_mesh(mesh):
            loss, grads, split = grads_of(unflatten(state["params"], full), batch)
        loss = loss.float()
        if split:
            n = math.prod(mesh_shape(mesh)[a] for a in dp)
            loss = _sum_over(loss / n, _dp_groups(mesh))
        count, lr_scale = update(state, full, grads, split)
        metrics = {"loss": loss, "lr_scale": lr_scale.float()}
        return ({"params": state["params"],
                 "opt": {"m": state["opt"]["m"], "v": state["opt"]["v"],
                         "count": count},
                 "step": state["step"] + 1}, metrics)

    return train_step


# ------------------------------------------------------------ serve steps
def make_mesh_prefill_step(cfg: ArchConfig, mesh, max_seq: int | None = None):
    """``prefill_step(params, batch)`` for parameters placed on ``mesh``:
    the parameters gathered, the rank's share of the batch prefilled (its
    logits and caches are the share's)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        full = tree_map(full_tensor, params)
        share, split = _share(batch, mesh)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            return serve_prefill(full, share, cfg, max_seq=max_seq)

    return prefill_step


def make_mesh_decode_step(cfg: ArchConfig, mesh):
    """``decode_step(params, cache, batch) -> (logits, cache)`` for
    parameters and a cache placed on ``mesh``: the parameters gathered, the
    cache gathered to the rank's batch rows with every head and position
    (the compute over ``model`` is replicated), one token decoded, the new
    cache cut back into its placement (in place) and the logits gathered
    over the data axes (replicated, as the reference's ``out_shardings``)."""
    names = list(mesh_shape(mesh))
    dp = dp_axes(mesh)

    def rows(dt) -> list:
        # the batch rows' placement over the data axes kept, the rest gathered
        return [p if names[i] in dp and p.is_shard() and p.dim == 1 else Replicate()
                for i, p in enumerate(dt.placements)]

    @torch.no_grad()
    def decode_step(params, cache, batch):
        full = tree_map(full_tensor, params)
        share, split = _share(batch, mesh)
        work = tree_map(lambda dt: local(dt.redistribute(mesh, rows(dt))), cache)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            logits, work = serve_decode(full, work, share, cfg)
        for w, dt in zip(leaves(work), leaves(cache)):
            back = DTensor.from_local(w, mesh, rows(dt), run_check=False)
            local(dt).copy_(local(back.redistribute(mesh, list(dt.placements))))
        if split:
            logits = full_tensor(DTensor.from_local(
                logits, mesh, [Shard(0) if a in dp else Replicate() for a in names],
                run_check=False))
        return logits, cache

    return decode_step
