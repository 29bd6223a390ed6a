"""Training, prefill and decode on a ``DeviceMesh``: the state placed as
DTensor shards by the reference's rules, the steps data-parallel over
``pod``/``data`` and tensor-parallel over ``model``.

The train step (:func:`make_mesh_train_step`) on every rank:

1. computes on each rank's shard of every parameter leaf, with the FSDP
   shards (a leaf the rules shard over ``data``) gathered over ``data``
   only, by :func:`~repro_torch.distributed.tp.gather_data`: a block's
   leaves inside the block, where it runs (the model's ``fetch``, in the
   forward pass and again in remat's recompute, and dropped after each),
   the leaves outside the blocks once a microbatch. A leaf the
   rules shard over ``model`` stays the rank's shard, and is never
   gathered over ``model``;
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
   over the whole batch (:func:`~repro_torch.models.layers.split_batch`).
   Each block's slice of a stacked leaf is an autograd leaf of its own, so
   its gradient comes a block at a time, and an FSDP leaf's is never
   stacked: its moments and parameter are updated a block at a time too;
4. averages the gradients over the data axes straight into each moment
   leaf's placement, and the loss over the same ranks. An FSDP leaf's
   gradient arrives so from the gather's backward, already the rank's
   shard (a reduce-scatter over ``data``, as its moments are placed); the
   others take a reduce-scatter into the ZeRO shard (DTensor's ``Partial``
   -> ``Shard``), or a ``c10d`` all-reduce where the moment is replicated
   over the data axes;
5. clips by the global norm (one all-reduce of the leaves' sums of squares)
   and updates each rank's shards with AdamW; a moment shard finer than
   its parameter's placement updates that slice of the parameter, and the
   slices are all-gathered back over the data axes. q8 moments are blocked
   256 elements at a time along the whole flattened leaf and sharded by
   row over ``data`` only: each rank updates the positions of its own rows
   that lie in its ``model`` shard (or its slice of them), from the
   ``model`` shard's gradient or, for an FSDP leaf, from the FSDP shards
   exchanged by an all-to-all over ``data``, and the step goes back the
   same way (:func:`~repro_torch.optim.q8_shard.update_leaf`); no q8 row
   and no whole gradient is gathered.

The prefill and decode steps gather each block's FSDP shards where the
block runs and drop them after it, and the other leaves' once a call.
Where the batch is smaller than the data axes (``long_500k``'s batch of
one), ``cache_specs_tree`` splits a KV cache's sequence over ``data``: the
prefill computes the whole cache on every rank and keeps the rank's slice
of it, cut from the local tensor, and the decode step attends on that
slice, written in place, its softmax combined over ``data`` by three
``c10d`` all-reduces an attention sublayer
(:func:`~repro_torch.models.layers.split_sequence`). No cache leaf is
gathered or redistributed.

A mesh axis of one rank is never redistributed over: a shard over it is
the whole, so the steps issue no DTensor collective there (gloo runs no
functional collective on CUDA tensors). Over a data axis of more than one
rank, the FSDP shards are gathered and their gradients reduced, the
gradients of leaves whose moments it replicates summed and the decode's
logits gathered by ``c10d`` calls, so a state whose moments no rule shards
finer than its parameters trains and serves over gloo on CUDA tensors too.
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
                                              dp_axes, dp_size, local, mesh_shape,
                                              use_mesh)
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import loss_fn, serve_decode, serve_prefill
from repro_torch.models.transformer import STACKS, abstract_cache, unstack_blocks
from repro_torch.optim import q8_shard
from repro_torch.optim.adamw import (AdamWConfig, apply_step, cosine_schedule,
                                     moment_step, param_nodes, step_scalars)
from repro_torch.tree import leaves, leaves_with_paths, tree_map


def full_tensor(dt) -> torch.Tensor:
    """A DTensor's whole value on every rank (an all-gather over the mesh
    dims it is sharded on; nothing for a replicated one)."""
    mesh = dt.device_mesh
    return dt.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


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


def _fsdp_dim(mesh, placements) -> int | None:
    """The tensor dim of a parameter that its FSDP shards split over
    ``data`` (an axis of more than one rank), or None."""
    sizes = mesh_shape(mesh)
    if sizes.get("data", 1) == 1:
        return None
    p = placements[list(sizes).index("data")]
    return p.dim if p.is_shard() else None


def _fsdp(mesh, params, split: bool = False):
    """``(gather, fetch)`` for the DTensor tree ``params``, each gathering
    FSDP shards over ``data`` (:func:`~repro_torch.distributed.tp.gather_data`)
    and passing the other leaves as they are (where no leaf is
    FSDP-sharded, the identity and None): ``gather`` maps a tree of the
    rank's local tensors to one whose leaves outside the stacked blocks
    are gathered, once for the call; ``fetch`` is the model's
    (:mod:`repro_torch.models.transformer`), a block's leaves where the
    block runs. Backward, an FSDP leaf's gradient comes back as the rank's
    shard: averaged over the data axes where the batch was ``split``, the
    rank's slice of it where not."""
    dims = tree_map(lambda dt: _fsdp_dim(mesh, dt.placements), params)
    if all(d is None for d in leaves(dims)):
        return (lambda tree: tree), None
    data = mesh.get_group("data")
    over = [mesh.get_group(a) for a in dp_axes(mesh) if a != "data"] if split else None

    def one(t, d, lead=0):  # a block's leaves lack the stacked dim
        return t if d is None else tp.gather_data(t, d - lead, data, over)

    def gather(tree):
        return {k: v if k in STACKS else tree_map(one, v, dims[k]) for k, v in tree.items()}

    def fetch(tree, stack):
        return tree_map(lambda t, d: one(t, d, 1), tree, dims[stack])

    return gather, fetch


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


def _stacked(path: str) -> bool:
    return path.split("/")[0] in STACKS


def _block_leaves(shards: dict) -> tuple[dict, list, list]:
    """``shards`` (a parameter tree of local tensors) with every leaf a new
    autograd leaf viewing it, and each stacked subtree a list of its
    blocks' trees (which the model takes as the stack); those leaves, and
    beside each its parameter's path, block after block."""
    tree, flat, paths = {}, [], []
    for k in sorted(shards):
        parts = unstack_blocks(shards[k]) if k in STACKS else [shards[k]]
        parts = [tree_map(lambda t: t.detach().requires_grad_(), b) for b in parts]
        tree[k] = parts if k in STACKS else parts[0]
        for b in parts:
            for path, t in leaves_with_paths(b, k):
                flat.append(t)
                paths.append(path)
    return tree, flat, paths


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
    fsdp = [_fsdp_dim(mesh, s.placements()) for s in p_sh]
    # an FSDP block leaf's gradient and AdamW update go a block at a time
    by_block = [fd is not None and not opt.quantized_moments and _stacked(p)
                for (p, _), fd in zip(leaves_with_paths(shardings["params"]), fsdp)]
    names = list(mesh_shape(mesh))
    dp = dp_axes(mesh)

    def grads_of(params, batch):
        """The loss and gradients of the rank's share of ``batch`` for the
        DTensor tree ``params``, summed over microbatches in fp32 as
        ``make_train_step`` does, and whether the batch was split. An FSDP
        leaf's gradient is the rank's shard, already averaged over the data
        axes where the batch was split (:func:`_fsdp`); where
        ``by_block``, it is the list of its blocks' gradients, and the
        other stacked leaves' are stacked."""
        tree, flat, paths = _block_leaves(tree_map(local, params))

        def one(part):
            share, split = _share(part, mesh)
            with torch.enable_grad(), \
                    layers.split_batch(_dp_groups(mesh) if split else []):
                gather, fetch = _fsdp(mesh, params, split)
                loss = loss_fn(gather(tree), share, cfg, remat, fetch)
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
            return loss.detach(), list(grads), split

        if microbatches == 1:
            loss, grads, split = one(batch)
        else:
            loss, acc, split = None, None, False
            for i in range(microbatches):
                def part(x):
                    b = x.shape[0]
                    if b % microbatches:
                        raise ValueError(f"batch {b} is not a multiple of "
                                         f"{microbatches} microbatches")
                    n = b // microbatches
                    return x[i * n : (i + 1) * n]

                loss_mb, g, split = one({k: part(v) for k, v in batch.items()})
                if acc is None:
                    loss = torch.zeros((), dtype=torch.float32, device=loss_mb.device)
                    acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                           for x in g]
                loss = loss + loss_mb
                for a, x in zip(acc, g):
                    a.add_(x)
                del g
            loss, grads = loss / microbatches, [a.div_(microbatches) for a in acc]
            del acc
        of: dict = {}
        for path, g in zip(paths, grads):
            of.setdefault(path, []).append(g)
        del grads
        out = []
        for (path, _), keep in zip(leaves_with_paths(params), by_block):
            g = of.pop(path)
            out.append(g if keep else torch.stack(g) if _stacked(path) else g[0])
        return loss, out, split

    @torch.no_grad()
    def update(state, grads, split: bool):
        """Average ``grads`` (the rank's ``model`` shards; an FSDP leaf's
        its shard, averaged already) into the moments' placements, clip by
        the global norm and update every rank's shards in place."""
        n = math.prod(mesh_shape(mesh)[a] for a in dp) if split else 1
        reduced, sq = [], []
        for g, ps, ms, fd in zip(grads, p_sh, m_sh, fsdp):
            on_model = _on_model(mesh, ps.placements())
            g_in = [Partial() if split and a in dp else p for a, p in zip(names, on_model)]
            to = on_model if opt.quantized_moments else list(ms.placements())
            if fd is not None:
                # averaged into the rank's shard by the gather's backward; its
                # moments have the parameter's placement (or are q8 rows)
                to = list(ps.placements())
                reduced.append(g)
            elif split and all(p.is_replicate() for a, p in zip(names, to) if a in dp):
                # Partial -> Replicate over the data axes: the c10d all-reduce,
                # which gloo also runs on CUDA tensors
                reduced.append(_sum_over((g.float() / n).contiguous(), _dp_groups(mesh)))
            else:
                gd = DTensor.from_local(g.float() / n if n > 1 else g.float(), mesh,
                                        _same(mesh, to, g_in), run_check=False)
                reduced.append(_to(gd, to))
            r = _replicas(mesh, to)
            parts = reduced[-1] if isinstance(reduced[-1], list) else [reduced[-1]]
            s = sum(torch.sum(torch.square(x.float())) for x in parts)
            sq.append(s / r if r > 1 else s)
        sq = torch.stack(sq)
        dist.all_reduce(sq)  # each shard counted once over the world
        gnorm = torch.sqrt(sum(sq.unbind()))
        count = state["opt"]["count"] + 1
        lr_scale = cosine_schedule(local(state["step"]), total=schedule_total)
        clip, bc1, bc2, lr = step_scalars(local(count), gnorm, opt, lr_scale)
        nodes = param_nodes(state["params"], state["opt"]["m"], state["opt"]["v"])
        for (p, m, v), g, ps, ms in zip(nodes, reduced, p_sh, m_sh):
            if isinstance(g, list):  # block by block, on views of the shards
                for i, gi in enumerate(g):
                    apply_step(local(p)[i], moment_step(gi, local(m)[i], local(v)[i],
                                                        gi.shape, clip, bc1, bc2, opt),
                               lr, opt)
                continue
            if opt.quantized_moments:  # on the rank's own rows
                q8_shard.update_leaf(p, g, m, v, clip, bc1, bc2, lr, opt)
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
        with use_mesh(mesh):
            loss, grads, split = grads_of(state["params"], batch)
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
def _splits_sequence(mesh, placements) -> bool:
    """Whether a cache leaf's placements split its sequence (dim 2) over
    ``data`` of more than one rank, as ``cache_specs_tree`` splits
    ``long_500k``'s caches (``pod`` never splits them)."""
    sizes = mesh_shape(mesh)
    p = dict(zip(sizes, placements)).get("data")
    return sizes.get("data", 1) > 1 and p.is_shard() and p.dim == 2


def _seq_split(mesh, cache) -> dict:
    """``{sublayer: {leaf names}}`` of a placed cache's leaves whose
    sequence is split over ``data`` (the argument of
    :func:`~repro_torch.models.layers.split_sequence`)."""
    out: dict = {}
    for key, sub in cache["blocks"].items():
        for name, dt in sub.items():
            if _splits_sequence(mesh, dt.placements):
                out.setdefault(key, set()).add(name)
    return out


def make_mesh_prefill_step(cfg: ArchConfig, mesh, max_seq: int | None = None):
    """``prefill_step(params, batch) -> (logits, cache)`` for parameters
    placed on ``mesh``: their FSDP shards gathered a block at a time, the
    rank's share of the batch prefilled tensor-parallel over ``model``; the
    logits are the share's (every vocabulary column), and the cache is
    DTensors placed by
    :func:`~repro_torch.distributed.sharding.cache_specs_tree`, each rank
    having written its own shard of every leaf. Where a leaf's sequence is
    split over ``data`` (a batch smaller than the data axes), every rank
    computes the whole leaf and keeps its slice of the sequence, cut from
    its local tensor (no collective)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        share, split = _share(batch, mesh)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []):
            gather, fetch = _fsdp(mesh, params)
            logits, cache = serve_prefill(gather(tree_map(local, params)), share, cfg,
                                          max_seq=max_seq, fetch=fetch)
        B, S = batch["tokens"].shape
        seq = max_seq or S
        whole = abstract_cache(cfg, B, seq)
        specs = cache_specs_tree(whole, mesh, cfg, ShapeConfig("prefill", seq, B, "decode"))

        def place(w, spec, like):
            want = list(spec.placements())
            if _splits_sequence(mesh, want):
                w = w.chunk(mesh_shape(mesh)["data"], 2)[mesh.get_local_rank("data")].clone()
            return DTensor.from_local(w, mesh, want, run_check=False, shape=like.shape,
                                      stride=like.stride())

        return logits, tree_map(place, cache, specs, whole)

    return prefill_step


def make_mesh_decode_step(cfg: ArchConfig, mesh):
    """``decode_step(params, cache, batch) -> (logits, cache)`` for
    parameters and a cache placed on ``mesh``: the parameters' FSDP shards
    gathered a block at a time, one token of the rank's batch rows decoded
    tensor-parallel over ``model`` against the rank's shard of the cache,
    written in place, and the logits gathered over the data axes
    (replicated, as the reference's ``out_shardings``). A cache leaf split
    along its sequence over ``data`` stays the rank's slice: attention runs
    on it and combines its softmax over ``data``
    (:func:`~repro_torch.models.layers.split_sequence`); no leaf is
    gathered or redistributed."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        share, split = _share(batch, mesh)
        work = tree_map(local, cache)
        seq = _seq_split(mesh, cache)
        with use_mesh(mesh), layers.split_batch(_dp_groups(mesh) if split else []), \
                layers.split_sequence(mesh.get_group("data") if seq else None, seq):
            gather, fetch = _fsdp(mesh, params)
            logits, work = serve_decode(gather(tree_map(local, params)), work, share, cfg,
                                        fetch=fetch)
        for w, dt in zip(leaves(work), leaves(cache)):
            if w is not local(dt):  # the position; the blocks' are written in place
                local(dt).copy_(w)
        if split:  # every share's rows, outer axis major (c10d all-gathers)
            for g in reversed(_dp_groups(mesh)):
                logits = tp.gather(logits, 0, g)
        return logits, cache

    return decode_step
