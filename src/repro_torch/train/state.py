"""The train state tree and its shardings, the port's copy of
``repro.train.state``: ``make_state``, ``make_abstract_state`` and
``state_shardings`` (the parameters' rules plus ZeRO-1 on the moments)."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import build_params
from repro_torch.models.transformer import abstract_params
from repro_torch.optim.adamw import AdamWConfig, abstract_state, init_state


def make_state(cfg: ArchConfig, opt: AdamWConfig, seed: int = 0,
               device="cuda") -> dict:
    """``{"params", "opt", "step"}``: random parameters (``build_params``),
    zero moments and step 0, on ``device``."""
    dev = resolve_device(device)
    params = build_params(cfg, seed=seed, device=dev)
    return {"params": params, "opt": init_state(params, opt),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_abstract_state(cfg: ArchConfig, opt: AdamWConfig) -> dict:
    """The same tree as ``meta`` tensors: shapes and dtypes only."""
    params = abstract_params(cfg)
    return {"params": params, "opt": abstract_state(params, opt),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_shardings(abstract, mesh, cfg: ArchConfig, fsdp: bool = False) -> dict:
    """Param shardings + ZeRO-1 optimizer shardings (data-axis extension),
    as a tree of :class:`~repro_torch.distributed.sharding.NamedSharding`
    over ``mesh`` (a ``DeviceMesh`` or a ``{name: size}`` mapping). q8
    moment leaves (``q``/``scale``) are sharded by row over ``data``; the
    ``count`` and ``step`` leaves are replicated."""
    from repro_torch.distributed.sharding import (NamedSharding, _extend_fsdp,
                                                  mesh_shape, param_specs_tree)
    from repro_torch.tree import leaves_with_paths, unflatten

    pspecs = param_specs_tree(abstract["params"], mesh, cfg, fsdp)
    data = mesh_shape(mesh)["data"]

    def moment_spec(path: str, leaf) -> tuple:
        keys = path.split("/")
        if keys[-1] in ("q", "scale"):
            # quantized moment leaves get simple ZeRO row sharding
            return ("data" if leaf.shape[0] % data == 0 else None,) + \
                (None,) * (leaf.dim() - 1)
        # the parameter's spec, found by the moment's path
        sub = pspecs
        for k in keys:
            if isinstance(sub, dict) and k in sub:
                sub = sub[k]
        spec = sub if isinstance(sub, tuple) else (None,) * leaf.dim()
        return _extend_fsdp(spec, tuple(leaf.shape), mesh, "data")

    def moment_shardings(moments):
        return unflatten(moments, [NamedSharding(mesh, moment_spec(p, leaf))
                                   for p, leaf in leaves_with_paths(moments)])

    return {
        "params": unflatten(pspecs, [NamedSharding(mesh, s) for _, s in
                                     leaves_with_paths(pspecs)]),
        "opt": {
            "m": moment_shardings(abstract["opt"]["m"]),
            "v": moment_shardings(abstract["opt"]["v"]),
            "count": NamedSharding(mesh, ()),
        },
        "step": NamedSharding(mesh, ()),
    }
