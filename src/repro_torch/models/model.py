"""Model entry points: family dispatch, loss, serve paths, input specs,
parameters, caches and demo batches.

``input_specs(cfg, shape)`` gives ``meta`` tensors standing in for every
model input of an (architecture x shape) cell (shapes and dtypes, nothing
allocated), for the launcher and the dry-run; ``param_specs`` and
``cache_specs`` do the same for the parameters and the decode cache.

Every entry point that makes tensors takes ``device=`` and defaults to the
card (:func:`repro_torch.device.resolve_device`); the others run where their
inputs lie.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import tp
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.layers import model_group
from repro_torch.models.transformer import (abstract_cache, abstract_params,
                                            decode_step, encoder_forward, forward,
                                            init_cache, init_params, prefill,
                                            torch_dtype)


def get_memory(params, batch: dict, cfg: ArchConfig):
    """Resolve the cross-attention memory for encdec/vlm families."""
    if cfg.family == "encdec":
        return encoder_forward(params, batch["enc_embed"], cfg)
    if cfg.family == "vlm":
        return batch["vision_embed"]
    return None


def model_forward(params, batch: dict, cfg: ArchConfig, remat: bool = True):
    memory = get_memory(params, batch, cfg)
    return forward(params, batch["tokens"], cfg, memory=memory, remat=remat)


def loss_fn(params, batch: dict, cfg: ArchConfig, remat: bool = True):
    """Token-mean cross entropy in f32 (stable logsumexp). Differentiable:
    :mod:`repro_torch.train.train_step` takes its gradients with
    ``torch.autograd.grad``; ``remat`` as in :func:`forward
    <repro_torch.models.transformer.forward>`. Where the logits are the
    rank's vocabulary columns (a head split over ``model``), it is the
    vocabulary-parallel cross entropy: the max, the sum of exponentials and
    the target's logit are all-reduced over ``model``, and no rank forms
    the whole (B, S, V) logits."""
    logits = model_forward(params, batch, cfg, remat=remat).float()
    targets = batch["targets"].long()
    if logits.shape[-1] < cfg.vocab_size:
        return _vocab_parallel_xent(logits, targets)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    return (logz - gold).mean()


def _vocab_parallel_xent(logits, targets):
    """The token-mean cross entropy of the rank's vocabulary columns
    ``logits`` (..., V/m), the columns of rank r being [r V/m, (r+1) V/m)."""
    g = model_group()
    Vl = logits.shape[-1]
    shift = tp.all_max(logits.amax(dim=-1, keepdim=True), g)
    z = logits - shift
    sumexp = tp.reduce(torch.exp(z).sum(dim=-1), g)
    ids = targets - tp.rank(g) * Vl
    inside = (ids >= 0) & (ids < Vl)
    gold = torch.take_along_dim(z, ids.clamp(0, Vl - 1)[..., None], dim=-1)[..., 0]
    gold = tp.reduce(gold.masked_fill(~inside, 0.0), g)
    return (torch.log(sumexp) - gold).mean()


def serve_prefill(params, batch: dict, cfg: ArchConfig, max_seq: int | None = None):
    memory = get_memory(params, batch, cfg)
    return prefill(params, batch["tokens"], cfg, memory=memory, max_seq=max_seq)


def serve_decode(params, cache, batch: dict, cfg: ArchConfig):
    return decode_step(params, cache, batch["token"], cfg)


# --------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str) -> dict:
    """``meta`` stand-ins for the cell's model inputs.

    train   -> {"tokens","targets"} (+ modality stubs)
    prefill -> {"tokens"}           (+ modality stubs)
    decode  -> {"token"}            (cache specs come from cache_specs())
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((B, S), torch.int32)
        specs["targets"] = _meta((B, S), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((B, S), torch.int32)
    else:  # decode: one new token against a seq_len cache
        specs["token"] = _meta((B, 1), torch.int32)
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["enc_embed"] = _meta((B, cfg.enc_seq, cfg.d_model), dt)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vision_embed"] = _meta((B, cfg.n_vision_tokens, cfg.d_model), dt)
    return specs


def param_specs(cfg: ArchConfig):
    return abstract_params(cfg)


def cache_specs(cfg: ArchConfig, shape: ShapeConfig | str):
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.kind != "decode":
        raise ValueError(f"cache specs are for decode cells, not {shape.kind}")
    return abstract_cache(cfg, shape.global_batch, shape.seq_len)


# ------------------------------------------------------------ concrete build
def to_device(tree, device):
    """A tree of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def build_params(cfg: ArchConfig, seed: int = 0, device="cuda"):
    """Random parameters in ``cfg.dtype``, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``: the
    card and the host get the same weights for one seed, and a config in
    bf16 gets the bf16 rounding of the fp32 config's weights. (The
    reference draws from ``jax.random``, which torch cannot reproduce; to
    compare the two, convert the reference's tree with
    :func:`repro_torch.convert.params_from_reference`.)"""
    dev = resolve_device(device)
    key = torch.Generator(device="cpu").manual_seed(seed)
    return to_device(init_params(key, cfg), dev)


def build_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda"):
    return init_cache(cfg, batch, max_seq, device=resolve_device(device))


def demo_batch(cfg: ArchConfig, batch: int, seq: int, kind: str = "train",
               seed: int = 0, device="cuda") -> dict:
    """Small concrete batch for smoke tests: the reference's numbers (numpy
    ``default_rng(seed)``), as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: dict = {}
    dt = torch_dtype(cfg.dtype)

    def ints(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    if kind == "decode":
        out["token"] = ints(rng.integers(0, cfg.vocab_size, (batch, 1)))
    else:
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        out["tokens"] = ints(toks[:, :-1])
        if kind == "train":
            out["targets"] = ints(toks[:, 1:])
    if cfg.family == "encdec" and kind != "decode":
        out["enc_embed"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.enc_seq, cfg.d_model))).to(dt).to(dev)
    if cfg.family == "vlm" and kind != "decode":
        out["vision_embed"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.n_vision_tokens, cfg.d_model))).to(dt).to(dev)
    return out
