"""Training, prefill and decode on a ``DeviceMesh``: the state placed as
DTensor shards by the reference's rules, the steps data-parallel over
``pod``/``data`` and tensor-parallel over ``model``.

The train step (:func:`make_mesh_train_step`) on every rank:

1. all-gathers each parameter leaf over the data axes only (its FSDP
   shards); a leaf the rules shard over ``model`` stays the rank's shard,
   and is never gathered over ``model``;
2. takes the rank's share of the batch: the global batch (every rank holds
   it, since the data order is a function of the step) cut by
   :func:`~repro_torch.distributed.sharding.batch_specs`, microbatch by
   microbatch as the reference reshapes it;
3. computes the loss and its gradients on that share, tensor-parallel over
   ``model`` (:mod:`repro_torch.models.layers`): every rank computes on its
   own shard of each ``model``-sharded leaf, the ranks of a ``model`` group
   hold the same tokens and meet in the collectives of
   :mod:`repro_torch.distributed.tp`, the logits stay split by vocabulary
   and the loss is the vocabulary-parallel cross entropy. The gradient of
   a ``model``-sharded leaf is the rank's shard; that of a replicated leaf
   comes out equal on every rank of a ``model`` group. MoE layers route
   over the whole batch (:func:`~repro_torch.models.layers.split_batch`);
4. averages the gradients over the data axes straight into each moment
   leaf's placement (a reduce-scatter into the ZeRO shard, DTensor's
   ``Partial`` -> ``Shard``; a ``c10d`` all-reduce where the moment is
   replicated over them), and the loss over the same ranks;
5. clips by the global norm (one all-reduce of the leaves' sums of squares)
   and updates each rank's shards with AdamW; a moment shard finer than
   its parameter's placement updates that slice of the parameter, and the
   slices are all-gathered back over the data axes. q8 moments are blocked
   256 elements at a time along the whole flattened leaf and sharded by
   row over ``data`` only: their rows are gathered (int8 and scales) and a
   ``model``-sharded gradient is gathered over ``model`` (the gradient, not
   the parameter), the moments and the Adam step are computed for the
   whole leaf, and each rank applies the step's slice to its parameter
   shard and keeps its rows.

A mesh axis of one rank is never redistributed over: a shard over it is
the whole, so the steps issue no DTensor collective there (gloo runs no
functional collective on CUDA tensors). Over a data axis of more than one
rank, the gradients of leaves whose moments it replicates are summed and
the decode's logits gathered by ``c10d`` calls, so a state that no rule
shards over ``data`` trains and serves over gloo on CUDA tensors too.
Every share is the same size (``batch_specs`` splits only what divides),
so the mean of the ranks' token means is the one-device loss, and the step
gives the one-device step's values up to the order of its sums.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.distributed import tp
from repro_torch.distributed.sharding import (batch_specs, cache_specs_tree,
                                              dp_axes, dp_size, mesh_shape,
                                              use_mesh)
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import serve_decode, serve_prefill
from repro_torch.models.transformer import abstract_cache
from repro_torch.optim.adamw import (AdamWConfig, apply_step, cosine_schedule,
                                     moment_step, param_nodes, step_scalars)
from repro_torch.train.train_step import loss_and_grads
from repro_torch.tree import leaves, tree_map


def full_tensor(dt) -> torch.Tensor:
    """A DTensor's whole value on every rank (an all-gather over the mesh
    dims it is sharded on; nothing for a replicated one)."""
    mesh = dt.device_mesh
    return dt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def local(dt) -> torch.Tensor:
    """The rank's shard of a DTensor, writable in place."""
    return dt._local_tensor


def _same(mesh, have, want) -> list:
    """``want`` with the placement it already has on every mesh dim of one
    rank (where a shard is the whole)."""
    return [h if n == 1 else w for n, h, w in zip(mesh.shape, have, want)]


def _to(dt, want) -> torch.Tensor:
    """The rank's part of ``dt`` redistributed to the placements ``want``,
    with no collective over a mesh dim of one rank; ``dt``'s own local
    tensor where nothing changes."""
    want = _same(dt.device_mesh, dt.placements, want)
    if list(want) == list(dt.placements):
        return local(dt)
    return local(dt.redistribute(dt.device_mesh, want))


def _on_model(mesh, placements) -> list:
    """``placements`` over ``model`` kept, every other mesh dim replicated."""
    return [p if name == "model" else Replicate()
            for name, p in zip(mesh_shape(mesh), placements)]


def _gather_data(dt) -> torch.Tensor:
    """The rank's ``model`` shard of a parameter, its FSDP shards gathered
    over the data axes."""
    return _to(dt, _on_model(dt.device_mesh, dt.placements))


def _share(batch: dict, mesh) -> tuple[dict, bool]:
    """The rank's share of ``batch`` by ``batch_specs``, and whether the
    batch was split (its leading dim divides over data axes of more than
    one rank)."""
    specs = batch_specs(batch, mesh)
    split = dp_size(mesh) > 1 and any(s.spec and s.spec[0] is not None
                                      for s in leaves(specs))
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


def _model_dim(placements, names) -> int | None:
    """The tensor dim a leaf is sharded on over ``model``, or None."""
    p = placements[names.index("model")]
    return p.dim if p.is_shard() else None


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
    names = list(mesh_shape(mesh))
    dp = dp_axes(mesh)
    group = tp.group_of(mesh)

    def grads_of(params, batch):
        """The loss and gradients of the rank's share, summed over
        microbatches in fp32 as ``make_train_step`` does, and whether the
        batch was split."""
        if microbatches == 1:
            share, split = _share(batch, mesh)
            with layers.split_batch(_dp_groups(mesh) if split else []):
                loss, grads = loss_and_grads(params, share, cfg, remat)
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
                loss_mb, g = loss_and_grads(params, share, cfg, remat)
            if acc is None:
                loss = torch.zeros((), dtype=torch.float32, device=loss_mb.device)
                acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                       for x in leaves(g)]
            loss = loss + loss_mb
            for a, x in zip(acc, leaves(g)):
                a.add_(x)
        return loss / microbatches, [a / microbatches for a in acc], split

    @torch.no_grad()
    def update(state, grads, split: bool):
        """Average ``grads`` (the rank's ``model`` shards) into the
        moments' placements, clip by the global norm and update every
        rank's shards in place."""
        n = math.prod(mesh_shape(mesh)[a] for a in dp) if split else 1
        reduced, sq = [], []
        for g, ps, ms in zip(grads, p_sh, m_sh):
            on_model = _on_model(mesh, ps.placements())
            g_in = [Partial() if split and a in dp else p for a, p in zip(names, on_model)]
            to = on_model if opt.quantized_moments else list(ms.placements())
            if split and all(p.is_replicate() for a, p in zip(names, to) if a in dp):
                # Partial -> Replicate over the data axes: the c10d all-reduce,
                # which gloo also runs on CUDA tensors
                reduced.append(_sum_over((g.float() / n).contiguous(), _dp_groups(mesh)))
            else:
                gd = DTensor.from_local(g.float() / n if n > 1 else g.float(), mesh,
                                        _same(mesh, to, g_in), run_check=False)
                reduced.append(_to(gd, to))
            r = _replicas(mesh, to)
            s = torch.sum(torch.square(reduced[-1]))
            sq.append(s / r if r > 1 else s)
        sq = torch.stack(sq)
        dist.all_reduce(sq)  # each shard counted once over the world
        gnorm = torch.sqrt(sum(sq.unbind()))
        count = state["opt"]["count"] + 1
        lr_scale = cosine_schedule(local(state["step"]), total=schedule_total)
        clip, bc1, bc2, lr = step_scalars(local(count), gnorm, opt, lr_scale)
        nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"])
        for (p, m, v), g, ps, ms in zip(nodes, reduced, p_sh, m_sh):
            if opt.quantized_moments:
                # the leaf whole: its gradient gathered over model, its q8
                # rows over data; the step's slice applied to the shard
                d = _model_dim(ps.placements(), names)
                g = tp.gather(g, d, group) if d is not None else g
                mf = {k: _to(t, [Replicate()] * mesh.ndim).clone() for k, t in m.items()}
                vf = {k: _to(t, [Replicate()] * mesh.ndim).clone() for k, t in v.items()}
                step = moment_step(g, mf, vf, g.shape, clip, bc1, bc2, opt)
                apply_step(local(p), local(ps.place(step)), lr, opt)
                for node, whole in ((m, mf), (v, vf)):
                    for k in node:  # m and v share their rules
                        local(node[k]).copy_(local(ms[k].place(whole[k])))
                continue
            fine = _same(mesh, ps.placements(), ms.placements())
            if list(fine) == list(ps.placements()):
                apply_step(local(p), moment_step(g, local(m), local(v), g.shape,
                                                 clip, bc1, bc2, opt), lr, opt)
                continue
            pl = _to(p, fine).clone()
            apply_step(pl, moment_step(g, local(m), local(v), g.shape, clip, bc1,
                                       bc2, opt), lr, opt)
            back = DTensor.from_local(pl, mesh, fine, run_check=False)
            local(p).copy_(_to(back, ps.placements()))
        return count, lr_scale

    def train_step(state, batch):
        params = tree_map(_gather_data, state["params"])
        with use_mesh(mesh):
            loss, grads, split = grads_of(params, batch)
        loss = loss.float()
        if split:
            n = math.prod(mesh_shape(mesh)[a] for a in dp)
            loss = _sum_over(loss / n, _dp_groups(mesh))
        count, lr_scale = update(state, grads, split)
        metrics = {"loss": loss, "lr_scale": lr_scale.float()}
        return ({"params": state["params"],
                 "opt": {"m": state["opt"]["m"], "v": state["opt"]["v"],
                         "count": count},
                 "step": state["step"] + 1}, metrics)

    return train_step


# ------------------------------------------------------------ serve steps
def _rows(mesh, placements) -> list:
    """The placements a step computes a cache leaf in: its batch rows over
    the data axes and its split over ``model`` kept, any other data-axis
    split (the sequence of ``long_500k``'s caches) gathered."""
    dp = dp_axes(mesh)
    return [p if name == "model" or (name in dp and p.is_shard() and p.dim == 1)
            else Replicate() for name, p in zip(mesh_shape(mesh), placements)]


def make_mesh_prefill_step(cfg: ArchConfig, mesh, max_seq: int | None = None):
    """``prefill_step(params, batch) -> (logits, cache)`` for parameters
    placed on ``mesh``: their FSDP shards gathered, the rank's share of the
    batch prefilled tensor-parallel over ``model``; the logits are the
    share's (every vocabulary column), and the cache is DTensors placed by
    :func:`~repro_torch.distributed.sharding.cache_specs_tree`, each rank
    having written its own shard of every leaf."""

    @torch.no_grad()
    def prefill_step(params, batch):
        local_params = tree_map(_gather_data, params)
        share, split = _share(batch, mesh)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            logits, cache = serve_prefill(local_params, share, cfg, max_seq=max_seq)
        B, S = batch["tokens"].shape
        seq = max_seq or S
        specs = cache_specs_tree(abstract_cache(cfg, B, seq), mesh, cfg,
                                 ShapeConfig("prefill", seq, B, "decode"))

        def place(w, spec):
            want = list(spec.placements())
            dt = DTensor.from_local(w, mesh, _same(mesh, want, _rows(mesh, want)),
                                    run_check=False)
            return DTensor.from_local(_to(dt, want), mesh, want, run_check=False,
                                      shape=dt.shape, stride=dt.stride())

        return logits, tree_map(place, cache, specs)

    return prefill_step


def make_mesh_decode_step(cfg: ArchConfig, mesh):
    """``decode_step(params, cache, batch) -> (logits, cache)`` for
    parameters and a cache placed on ``mesh``: the parameters' FSDP shards
    gathered, one token of the rank's batch rows decoded tensor-parallel
    over ``model`` against the rank's shard of the cache, written in place
    (a cache split over a data axis along its sequence is gathered for the
    step and cut back), and the logits gathered over the data axes
    (replicated, as the reference's ``out_shardings``)."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        local_params = tree_map(_gather_data, params)
        share, split = _share(batch, mesh)
        work = tree_map(lambda dt: _to(dt, _rows(mesh, dt.placements)), cache)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            logits, work = serve_decode(local_params, work, share, cfg)
        for w, dt in zip(leaves(work), leaves(cache)):
            if w is local(dt):
                continue  # written in place
            rows = _same(mesh, dt.placements, _rows(mesh, dt.placements))
            back = DTensor.from_local(w, mesh, rows, run_check=False)
            local(dt).copy_(_to(back, list(dt.placements)))
        if split:  # every share's rows, outer axis major (c10d all-gathers)
            for g in reversed(_dp_groups(mesh)):
                logits = tp.gather(logits, 0, g)
        return logits, cache

    return decode_step

