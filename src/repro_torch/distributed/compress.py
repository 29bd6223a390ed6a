"""Gradient compression for cross-pod all-reduce, the port's copy of
``repro.distributed.compress``, on ``torch.distributed``.

int8-on-the-wire mean-all-reduce with a shared scale and error feedback:

  1. all_reduce(MAX) of |g| over the axis -> one shared f32 scale per
     tensor (a scalar collective, negligible bytes);
  2. local int8 quantisation (+ carry-in of last step's residual);
  3. **all_to_all of int8 chunks** — each member receives every peer's int8
     chunk for its slice (the reduce-scatter phase, 1 B/element on the
     wire), sums locally in int32 (no overflow: N <= 2^23 peers), and
     re-quantises the partial sum to int8 with a second shared scale;
  4. **all_gather of the int8 partial sums** (1 B/element) and dequantise.

Wire bytes ~= 2 B/element against 8 B/element for a ring f32 all-reduce.
The local quantisation residual is returned as the error-feedback buffer
for the next step (Karimireddy et al.-style EF). Rounding is half to even
(``torch.round``, as ``jnp.round``).

Where the reference runs in ``shard_map`` with the tree replicated over
the axis, here each rank passes its own tensors: the ranks of the axis's
process group (one mesh dim, ``"pod"`` by default) may hold different
gradients, and each gets their mean. The collectives are plain
``torch.distributed`` calls on that group (NCCL on the card, gloo on the
host); there is no kernel of the port on this path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.tree import leaves, tree_map, unflatten


def _quantize(g: torch.Tensor, group):
    m = g.abs().max()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(m / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compressed_psum_leaf(g: torch.Tensor, ef: torch.Tensor, group,
                          n_devices: int):
    """int8-wire mean over ``group`` for one tensor; returns (mean, new_ef)."""
    shape = g.shape
    g = g.float() + ef
    q, scale = _quantize(g, group)
    new_ef = g - q.float() * scale                      # error feedback

    flat = q.reshape(-1)
    pad = (-flat.numel()) % n_devices
    chunks = F.pad(flat, (0, pad)).reshape(n_devices, -1)  # (N, m) int8
    # reduce-scatter phase: int8 on the wire
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=group)   # peers' chunks for me
    part = recv.to(torch.int32).sum(dim=0, dtype=torch.int32)  # local int32 sum
    # re-quantise the partial sum so the gather phase is int8 too
    psum_f = part.float() * scale
    m2 = psum_f.abs().max()
    dist.all_reduce(m2, op=dist.ReduceOp.MAX, group=group)
    scale2 = torch.clamp(m2 / 127.0, min=1e-12)
    q2 = torch.clamp(torch.round(psum_f / scale2), -127, 127).to(torch.int8)
    # all-gather phase: int8 on the wire
    gathered = torch.empty(n_devices * q2.numel(), dtype=torch.int8, device=q2.device)
    dist.all_gather_into_tensor(gathered, q2, group=group)
    total = gathered.float() * scale2
    mean = (total[: g.numel()] / float(n_devices)).reshape(shape)
    return mean, new_ef


def compressed_pmean(tree, ef_tree, mesh, axis: str = "pod"):
    """Error-feedback int8-wire mean-all-reduce of a tree of tensors over
    mesh dim ``axis`` of ``mesh`` (a ``DeviceMesh``); every rank of that
    dim's group calls it with its own tree. Returns (mean_tree,
    new_error_feedback_tree), on the tensors' device."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    flat_t, flat_e = leaves(tree), leaves(ef_tree)
    if len(flat_t) != len(flat_e):
        raise ValueError("the error feedback tree does not match the tree")
    out = [_compressed_psum_leaf(g, ef, group, n) for g, ef in zip(flat_t, flat_e)]
    return (unflatten(tree, [o[0] for o in out]),
            unflatten(tree, [o[1] for o in out]))


def init_error_feedback(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)
