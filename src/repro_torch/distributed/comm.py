"""The count of the collectives the port issues, by kind: calls and bytes.

:class:`CollectiveCounter` is a ``TorchDispatchMode``: inside it, every
collective that reaches the dispatcher is counted where it is issued, the
``c10d`` ops of ``torch.distributed`` (what ``compressed_pmean`` and the MoE
routing call) and the functional ones DTensor's redistributions issue. The
same counter reads a real step on gloo or NCCL and the dry-run's step on
``meta`` tensors under the fake process group, so the two count alike.

Bytes are those of each op's result on this rank (the payload it receives),
as the reference's HLO analysis counts them: an all-gather counts the
gathered tensor, a reduce-scatter the shard, an all-reduce its tensor, an
all-to-all its output. A group of one rank counts too (NCCL still copies).
Each collective is also counted by the process group it runs on
(``by_group``, keyed ``(group name, kind)``: a mesh axis's group is
``mesh.get_group(axis).group_name``), and the shape of every all-gather's
result is kept with its group (``gathered``), which is how a test sees
that no parameter sharded over ``model`` is gathered over ``model``.
Every other op runs untouched, at the cost of one Python call each, so
keep the counter off timed work.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

#: ``namespace::op`` -> the kind the reference's records use
KINDS = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "broadcast",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "broadcast",
}


def _group_name(func, args) -> str | None:
    """The name of the group a collective runs on: the functional ops
    take it as their last string argument, the ``c10d`` ones take the
    boxed ``ProcessGroup``."""
    if func.namespace == "_c10d_functional":
        names = [a for a in args if isinstance(a, str)]
        return names[-1] if names else None
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).group_name
            except (RuntimeError, TypeError, AttributeError):
                continue
    return None


def tensor_bytes(x) -> int:
    """The bytes of the tensors in ``x`` (a tensor or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as cc: ...``; then ``cc.calls`` and
    ``cc.bytes`` map each kind to its count and bytes, ``cc.by_group``
    each ``(group name, kind)`` to its calls, and ``cc.gathered`` lists
    ``(group name, result shape)`` of every all-gather."""

    def __init__(self):
        super().__init__()
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self.by_group: Counter = Counter()
        self.gathered: list[tuple[str | None, tuple[int, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = KINDS.get(func._schema.name)
        if kind is not None:
            # c10d ops write their output into their first argument; the
            # functional ones return it
            result = args[0] if func.namespace == "c10d" else out
            self.calls[kind] += 1
            self.bytes[kind] += tensor_bytes(result)
            group = _group_name(func, args)
            self.by_group[group, kind] += 1
            if kind == "all-gather":
                for t in (result if isinstance(result, (list, tuple)) else [result]):
                    shapes = ([tuple(x.shape) for x in t] if isinstance(t, (list, tuple))
                              else [tuple(t.shape)])
                    self.gathered += [(group, sh) for sh in shapes]
        return out

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())
