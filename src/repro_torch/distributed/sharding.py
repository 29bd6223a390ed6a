"""Sharding rules: param/batch/cache partition specs per (arch x shape x
mesh), the port's copy of ``repro.distributed.sharding``.

Axes (per the production mesh spec):
  pod   — cross-pod data parallelism (multi-pod mesh only)
  data  — in-pod data parallelism; doubles as the FSDP/ZeRO shard axis
  model — tensor/expert parallelism

Rules are name-driven over the param tree (wq/wk/wv column-parallel, wo/w_down
row-parallel, experts over 'model' when divisible (EP) else per-expert TP,
SSM head-parallel, vocab-parallel embeddings when divisible). FSDP extends
large leaves with 'data' on the first free divisible dim; optimizer moments
always get the ZeRO-1 extension. Scan-stacked leaves carry a leading
``n_blocks`` dim that is never sharded (it is the scan axis).

The rules are pure functions of the axis names and sizes: ``mesh`` is a
``DeviceMesh`` or a plain ``{name: size}`` mapping, so they evaluate at
16x16 without 256 processes. A spec is a tuple whose entries are the
reference's ``PartitionSpec`` entries (``None``, an axis name, or a tuple of
names). :class:`NamedSharding` pairs a spec with its mesh, as the
reference's does, and turns it into DTensor placements
(:meth:`NamedSharding.placements`) and shards (:meth:`NamedSharding.place`)
on a ``DeviceMesh``.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from repro_torch.models import layers as _layers
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.tree import leaves_with_paths, tree_map, unflatten

mesh_shape = _layers.mesh_shape


@contextlib.contextmanager
def use_mesh(mesh):
    """Enter the mesh context the model code reads (``batch_axes``, the
    axis sizes)."""
    _layers.set_mesh_context(mesh)
    try:
        yield mesh
    finally:
        _layers.set_mesh_context(None)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def dp_axes(mesh) -> tuple:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _dp_entry(mesh):
    """The data axes as one spec entry: a tuple of names, or the one name
    (``PartitionSpec`` writes a tuple of one name as the name)."""
    dp = dp_axes(mesh)
    return dp if len(dp) != 1 else dp[0]


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in ("pod", "data"))


def _entries(spec: tuple) -> list[str]:
    return [a for p in spec for a in (p if isinstance(p, tuple) else (p,))
            if a is not None]


# ------------------------------------------------------------ placements
@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh, the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim in the mesh's order: ``Shard(d)``
        on every mesh dim that tensor dim ``d``'s entry names (a dim over
        ``("pod", "data")`` is sharded on both, pod-major as JAX orders
        it), ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            axes = [a for a in axes if a is not None]
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(f"spec {self.spec}: axes {axes} of dim {d} are not "
                                 f"in the mesh's order {names}")
            for i in pos:
                out[i] = Shard(d)
        return tuple(out)

    def local_shape(self, shape) -> tuple[int, ...]:
        """The shape of a rank's shard of a tensor of ``shape`` (every rule
        shards only dims the axes divide)."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                if a is not None:
                    if out[d] % sizes[a]:
                        raise ValueError(f"dim {d} of {tuple(shape)} is not a "
                                         f"multiple of {a}={sizes[a]}")
                    out[d] //= sizes[a]
        return tuple(out)

    def place(self, tensor: torch.Tensor):
        """``tensor`` (the whole leaf, on every rank) as a DTensor whose
        local part is this rank's shard, cut locally (no collective)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh, list(self.placements()),
                                 src_data_rank=None)

    def place_meta(self, tensor: torch.Tensor):
        """A DTensor over ``meta`` local shards of ``tensor``'s shape and
        dtype: the state of one rank for the dry-run, allocating nothing."""
        from torch.distributed.tensor import DTensor

        local = torch.empty(self.local_shape(tensor.shape), dtype=tensor.dtype,
                            device="meta")
        return DTensor.from_local(local, self.mesh, list(self.placements()),
                                  run_check=False, shape=tensor.shape,
                                  stride=_contiguous_stride(tensor.shape))


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def local(dt) -> torch.Tensor:
    """The rank's shard of a DTensor, writable in place."""
    return dt._local_tensor


def place_tree(tree, shardings, meta: bool = False):
    """Every leaf of ``tree`` placed by its :class:`NamedSharding`."""
    if meta:
        return tree_map(lambda t, s: s.place_meta(t), tree, shardings)
    return tree_map(lambda t, s: s.place(t), tree, shardings)


# ------------------------------------------------------------- param rules
def _leaf_rule(path: str, shape: tuple[int, ...], mesh,
               cfg: ArchConfig) -> tuple:
    """Base TP rule for one leaf (ignoring the stacked-blocks leading dim)."""
    m = axis_size(mesh, "model")

    def div(i):  # dim i divisible by model axis?
        return shape[i] % m == 0

    name = path.split("/")[-1]
    if "ffn" in path and len(shape) == 3:                 # MoE experts (E,.,.)
        E = shape[0]
        if E % m == 0:
            return ("model", None, None)                  # expert parallel
        if name in ("w_gate", "w_up") and div(2):
            return (None, None, "model")                  # per-expert TP
        if name == "w_down" and div(1):
            return (None, "model", None)
        return (None, None, None)
    if name == "router":
        return (None, None)
    if name in ("wq", "wk", "wv") and div(1):
        return (None, "model")                            # column parallel
    if name == "wo" and div(0):
        return ("model", None)                            # row parallel
    if name in ("bq", "bk", "bv") and div(0):
        return ("model",)
    if name in ("w_gate", "w_up") and div(1):
        return (None, "model")
    if name == "w_down" and div(0):
        return ("model", None)
    # --- SSM (head-parallel) ---
    if name in ("w_z", "w_x") and div(1):
        return (None, "model")
    if name == "w_dt" and div(1):
        return (None, "model")
    if name == "w_BC":
        return (None, None)
    if name in ("conv_x",) and div(1):
        return (None, "model")
    if name in ("conv_bx", "norm") and len(shape) == 1 and div(0) and "ssm" in path:
        return ("model",)
    if name in ("A_log", "D", "dt_bias") and div(0):
        return ("model",)
    if name == "w_out" and div(0):
        return ("model", None)
    # --- embeddings / head ---
    if name == "embed":
        if shape[0] % m == 0:
            return ("model", None)                        # vocab parallel
        if shape[1] % m == 0:
            return (None, "model")
        return (None, None)
    if name == "lm_head":
        if shape[1] % m == 0:
            return (None, "model")
        return (None, None)
    return (None,) * len(shape)


def _extend_fsdp(spec: tuple, shape: tuple[int, ...], mesh,
                 axis: str = "data", min_size: int = 1 << 20) -> tuple:
    """Add the FSDP/ZeRO axis on the first free dim divisible by its size."""
    d = axis_size(mesh, axis)
    if d <= 1 or math.prod(shape) < min_size:
        return spec
    if axis in _entries(spec):
        return spec  # already sharded on this axis (e.g. params under FSDP)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % d == 0 and dim >= d:
            parts[i] = axis
            return tuple(parts)
    return spec


def param_specs_tree(abstract_params, mesh, cfg: ArchConfig,
                     fsdp: bool = False):
    """Spec tree matching the (scan-stacked) param tree."""

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        stacked = "blocks" in path and len(shape) >= 1
        inner_shape = shape[1:] if stacked else shape
        spec = _leaf_rule(path, inner_shape, mesh, cfg)
        if fsdp:
            spec = _extend_fsdp(spec, inner_shape, mesh)
        if stacked:
            spec = (None, *spec)
        return spec

    return unflatten(abstract_params, [rule(p, leaf) for p, leaf in
                                       leaves_with_paths(abstract_params)])


def param_shardings(abstract_params, mesh, cfg: ArchConfig,
                    fsdp: bool = False):
    specs = param_specs_tree(abstract_params, mesh, cfg, fsdp)
    return unflatten(specs, [NamedSharding(mesh, s) for _, s in leaves_with_paths(specs)])


# ------------------------------------------------------------- batch rules
def batch_specs(input_tree, mesh):
    """Shard the leading (global batch) dim over (pod, data) when divisible
    (long_500k has batch 1: replicated input, sequence-parallel caches)."""
    dp = _dp_entry(mesh)
    dpn = dp_size(mesh)

    def rule(leaf):
        lead = dp if dp and leaf.shape and leaf.shape[0] % dpn == 0 else None
        spec = [lead] + [None] * (len(leaf.shape) - 1)
        return NamedSharding(mesh, tuple(spec))

    return tree_map(rule, input_tree)


# ------------------------------------------------------------- cache rules
def cache_specs_tree(abstract_cache, mesh, cfg: ArchConfig,
                     shape: ShapeConfig):
    """Decode-cache shardings.

    KV caches (n_blocks, B, S, K, hd): batch over (pod,data); head_dim over
    'model' (every assigned hd is divisible by 16). long_500k (batch=1) flips
    to sequence parallelism: S over 'data' for full-attention caches. SSM
    states shard heads over 'model', batch over (pod,data).
    """
    dp = _dp_entry(mesh)
    m = axis_size(mesh, "model")
    d = axis_size(mesh, "data")
    B = shape.global_batch
    seq_parallel = B < dp_size(mesh)

    def rule(keys, leaf):
        s = tuple(leaf.shape)
        if keys.endswith("pos"):
            return NamedSharding(mesh, ())
        if "state" in keys and len(s) == 5:      # (nb, B, H, P, N)
            hspec = "model" if s[2] % m == 0 else None
            bspec = dp if not seq_parallel and B % dp_size(mesh) == 0 else None
            return NamedSharding(mesh, (None, bspec, hspec, None, None))
        if "conv" in keys and len(s) == 4:       # (nb, B, W-1, C)
            cspec = "model" if s[3] % m == 0 else None
            bspec = dp if not seq_parallel and B % dp_size(mesh) == 0 else None
            return NamedSharding(mesh, (None, bspec, None, cspec))
        if len(s) == 5:                           # (nb, B, S, K, hd) KV
            hd_spec = "model" if s[4] % m == 0 else None
            sspec = ("data" if seq_parallel and s[2] % d == 0 and s[2] >= 4 * d
                     else None)
            bspec = (dp if not seq_parallel and B % dp_size(mesh) == 0
                     else None)
            return NamedSharding(mesh, (None, bspec, sspec, None, hd_spec))
        return NamedSharding(mesh, (None,) * len(s))

    return unflatten(abstract_cache, [rule(k, leaf) for k, leaf in
                                      leaves_with_paths(abstract_cache)])


# ------------------------------------------------------------ outputs
def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
