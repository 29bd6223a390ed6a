"""The train state tree, the port's copy of ``make_state`` and
``make_abstract_state`` of ``repro.train.state``. Its sharded half
(``state_shardings``) waits for the port's sharding slice."""

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
