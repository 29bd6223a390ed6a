"""Train and serve step builders, the port's copy of
``repro.train.train_step``.

``train_step``: the gradients of ``loss_fn`` (``torch.autograd.grad``, in
the parameters' dtype), microbatched gradient accumulation in fp32 (a loop
where the reference scans), rematerialisation per block, the AdamW update
and the cosine schedule. The step runs eagerly and updates the state's
parameters and moments in place. ``make_prefill_step`` and
``make_decode_step`` wrap the serve entry points.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import loss_fn, serve_decode, serve_prefill
from repro_torch.optim.adamw import AdamWConfig, apply_updates, cosine_schedule
from repro_torch.tree import leaves, tree_map, unflatten


def loss_and_grads(params, batch: dict, cfg: ArchConfig, remat: bool = True):
    """``loss_fn`` and its gradient for every parameter leaf (zeros for a
    leaf the loss does not reach), in the leaf's dtype: the reference's
    ``jax.value_and_grad(loss_fn)``. The parameters are not modified."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch, cfg, remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig, opt: AdamWConfig, microbatches: int = 1,
                    remat: bool = True, schedule_total: int = 10_000):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state's
    parameters and moments are written in place, and ``metrics`` holds the
    fp32 ``loss`` and ``lr_scale`` on the state's device."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, grads = loss_and_grads(params, batch, cfg, remat)
        else:
            def part(x, i):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"{microbatches} microbatches")
                n = b // microbatches
                return x[i * n : (i + 1) * n]

            loss = torch.zeros((), dtype=torch.float32, device=state["step"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(microbatches):
                loss_mb, g = loss_and_grads(
                    params, {k: part(v, i) for k, v in batch.items()}, cfg, remat)
                loss = loss + loss_mb
                tree_map(lambda acc, x: acc.add_(x), grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)

        # the schedule reads the step before it is incremented
        lr_scale = cosine_schedule(state["step"], total=schedule_total)
        new_params, new_opt = apply_updates(params, grads, state["opt"], opt,
                                            lr_scale)
        metrics = {"loss": loss.float(), "lr_scale": lr_scale.float()}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step


def make_prefill_step(cfg: ArchConfig, max_seq: int | None = None):
    def prefill_step(params, batch):
        return serve_prefill(params, batch, cfg, max_seq=max_seq)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def step(params, cache, batch):
        return serve_decode(params, cache, batch, cfg)

    return step
