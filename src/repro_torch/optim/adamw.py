"""AdamW with optional 8-bit block-quantised moments, the port's copy of
``repro.optim.adamw``.

Plain functions over a tree of tensors (nested dicts, the port's parameter
layout). The 8-bit variant stores both Adam moments as int8 with per-block
(256-element) fp32 scales: 2.06 bytes a parameter of optimizer state
instead of 8. The bias corrections, the clip by the global norm and the
update run in fp32 as in the reference; :func:`apply_updates` writes the
parameters and moments in place (the same values the reference returns).
On a mesh, each rank updates a q8 leaf on the rows it holds
(:func:`repro_torch.optim.q8_shard.update_leaf`, the same elementwise
operations as :func:`moment_step` and :func:`apply_step`, from the same
:func:`advance`, :func:`adam_step`, :func:`q8_scale` and :func:`requantize`);
the other functions here update whole leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.tree import leaves, tree_map

BLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_moments: bool = False


# ----------------------------------------------------------- 8-bit moments
def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def quantize_q8(x: torch.Tensor) -> dict:
    """``x`` as int8 blocks of 256 with one fp32 scale a block: the block's
    largest magnitude over 127 (at least 1e-12), values rounded half to
    even and clipped to ±127."""
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, _pad_len(flat.numel()) - flat.numel())).reshape(-1, BLOCK)
    scale = q8_scale(blocks.abs().amax(dim=1, keepdim=True))
    return {"q": requantize(blocks, scale), "scale": scale.to(torch.float32)}


def q8_scale(peak: torch.Tensor) -> torch.Tensor:
    """A block's scale from its largest magnitude ``peak``."""
    return torch.clamp(peak / 127.0, min=1e-12)


def requantize(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``y`` in int8 steps of ``scale``, rounded half to even, clipped to ±127."""
    return torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)


def dequantize_q8(qs: dict, shape) -> torch.Tensor:
    blocks = qs["q"].to(torch.float32) * qs["scale"]
    return blocks.reshape(-1)[: math.prod(shape)].reshape(shape)


def _is_q8(node) -> bool:
    return isinstance(node, dict) and "q" in node


# ------------------------------------------------------------------- state
def init_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments (fp32 like each parameter, or q8 blocks) and an int32
    step count, on the parameters' device (``meta`` parameters give the
    abstract state)."""
    device = leaves(params)[0].device

    def zeros_like_moment(p):
        if cfg.quantized_moments:
            n = _pad_len(p.numel())
            return {"q": torch.zeros((n // BLOCK, BLOCK), dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros((n // BLOCK, 1), dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros_like(p, dtype=torch.float32)

    return {"m": tree_map(zeros_like_moment, params),
            "v": tree_map(zeros_like_moment, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(abstract_params, cfg: AdamWConfig) -> dict:
    """The state's tree of shapes and dtypes, as ``meta`` tensors."""
    return init_state(tree_map(lambda p: torch.empty_like(p, device="meta"),
                               abstract_params), cfg)


# ------------------------------------------------------------------ update
def global_norm(tree) -> torch.Tensor:
    """The fp32 L2 norm over every leaf, summed in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def step_scalars(count, gnorm, cfg: AdamWConfig, lr_scale=1.0):
    """The step's clip factor, bias corrections and learning rate, from the
    new count and the gradients' global norm."""
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** count.float()
    bc2 = 1.0 - cfg.b2 ** count.float()
    return clip, bc1, bc2, cfg.lr * lr_scale


def advance(old: torch.Tensor, x: torch.Tensor, beta: float) -> torch.Tensor:
    """A moment ``old`` advanced by ``x`` (the gradient, or its square)."""
    return beta * old + (1 - beta) * x


def adam_step(mf, vf, bc1, bc2, eps: float) -> torch.Tensor:
    """The Adam step m^/(sqrt(v^) + eps) of the advanced moments."""
    return (mf / bc1) / (torch.sqrt(vf / bc2) + eps)


@torch.no_grad()
def moment_step(g, m, v, shape, clip, bc1, bc2, cfg: AdamWConfig) -> torch.Tensor:
    """The moments of a leaf of ``shape`` advanced by its gradient ``g``
    (written into ``m`` and ``v``: fp32 tensors, or q8 dicts of the whole
    leaf), and the Adam step m^/(sqrt(v^) + eps) they give, in fp32."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * clip
    if cfg.quantized_moments:
        mf = dequantize_q8(m, shape)
        vf = dequantize_q8(v, shape)
    else:
        mf, vf = m, v
    mf = advance(mf, g, b1)
    vf = advance(vf, torch.square(g), b2)
    step = adam_step(mf, vf, bc1, bc2, cfg.eps)
    if cfg.quantized_moments:
        for dst, src in ((m, quantize_q8(mf)), (v, quantize_q8(vf))):
            dst["q"].copy_(src["q"])
            dst["scale"].copy_(src["scale"])
    else:
        m.copy_(mf)
        v.copy_(vf)
    return step


@torch.no_grad()
def apply_step(p, step, lr, cfg: AdamWConfig) -> None:
    """``p`` moved by the Adam ``step`` and the weight decay, in place."""
    p32 = p.float()
    p.copy_(p32 - lr * (step + cfg.weight_decay * p32))


@torch.no_grad()
def update_leaf(p, g, m, v, clip, bc1, bc2, lr, cfg: AdamWConfig) -> None:
    """One parameter leaf's AdamW update, written into ``p``, ``m`` and
    ``v`` (fp32 tensors, or q8 dicts of the whole leaf)."""
    apply_step(p, moment_step(g, m, v, p.shape, clip, bc1, bc2, cfg), lr, cfg)


def param_nodes(params, *trees) -> list[tuple]:
    """``(param leaf, node of each tree at its path)`` in sorted key order;
    a node is a tensor or, for q8 moments, the leaf's ``{"q", "scale"}``."""
    if isinstance(params, dict):
        out = []
        for k in sorted(params):
            out += param_nodes(params[k], *(t[k] for t in trees))
        return out
    return [(params, *trees)]


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step. Returns (params, state): the parameter and moment
    tensors passed in, written in place, and a new count."""
    count = state["count"] + 1
    scalars = step_scalars(count, global_norm(grads), cfg, lr_scale)
    for p, g, m, v in param_nodes(params, grads, state["m"], state["v"]):
        update_leaf(p, g, m, v, *scalars, cfg)
    return params, {"m": state["m"], "v": state["v"], "count": count}


# ---------------------------------------------------------------- schedule
def cosine_schedule(step, warmup: int = 100, total: int = 10_000,
                    floor: float = 0.1) -> torch.Tensor:
    """Relative LR multiplier: linear warmup then cosine to ``floor``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(1, warmup), max=1.0)
    prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
