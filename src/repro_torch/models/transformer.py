"""Unified decoder stack for all 10 assigned architectures.

The model is a loop over *blocks*; a block is the architecture's layer
period (gemma2: [local, global]; jamba: [7x mamba + 1x attn, MoE every 2nd];
llama-vision: [cross-attn + 4x self]; plain dense/MoE: 1 layer). Parameters
and caches keep the reference's layout: every leaf under ``blocks`` has a
leading block axis, and block ``i`` is ``{k: v[i]}``.

Three entry points per architecture (built in repro_torch.models.model):
  forward      — full-sequence logits
  prefill      — forward + materialised KV/SSM caches, last-position logits
  decode_step  — one token against the caches

Under a ``model`` axis (:mod:`repro_torch.models.layers`) the embedding is
looked up from the rank's rows (vocabulary-parallel: a masked lookup,
then an all-reduce) or columns (then an all-gather), ``forward`` returns
the rank's vocabulary columns of the logits where the head is split by
vocabulary, and ``prefill``/``decode_step`` gather them whole.

Each entry point takes ``fetch`` (None by default, and then nothing
changes): ``fetch(tree, stack)`` maps a block's tree of rank-local shards,
taken from the stacked subtree ``stack`` (``"blocks"`` or
``"enc_blocks"``), to the tree the block computes on. The mesh steps
(:mod:`repro_torch.train.mesh_step`) gather a block's FSDP shards there, as
the reference's ``lax.scan`` over the stacked blocks lets GSPMD gather one
block's inside the loop body, and drop them once the block has run. The
leaves outside the blocks (embedding, head, final norms) are taken as
given: the mesh steps gather those once, for the whole step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tp
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (out_proj, attend_cache, attention,
                                       cache_kv, decode_attention, init_attention,
                                       init_mlp, init_moe, mlp, model_group, moe,
                                       normal, rms_norm, sequence_group, softcap)
from repro_torch.models.ssm import init_ssm, init_ssm_cache, ssd_apply, ssd_decode

Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the parameter subtrees whose leaves carry a leading block axis
STACKS = ("blocks", "enc_blocks")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name."""
    return _DTYPES[name]


def block_at(tree: Params, i: int) -> Params:
    """Block ``i`` of a tree whose leaves carry a leading block axis."""
    return {k: block_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack_blocks(tree: Params | list[Params]) -> list[Params]:
    """The blocks of a tree whose leaves carry a leading block axis, as
    views: one ``unbind`` a leaf. Under autograd the blocks' gradients then
    reach each stacked leaf in one stack, where a ``block_at`` view per
    block would add a zero-filled gradient of the whole stacked leaf per
    block (n^2 in the leaf's size). A list of the blocks' trees is already
    unstacked, and is returned as it is (the mesh train step gives each
    block's leaves as autograd leaves of their own)."""
    if isinstance(tree, list):
        return tree
    cols = {k: unstack_blocks(v) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def stack_blocks(blocks: list[Params]) -> Params:
    """The blocks' trees stacked along a new leading axis per leaf."""
    return {k: stack_blocks([b[k] for b in blocks]) if isinstance(v, dict)
            else torch.stack([b[k] for b in blocks])
            for k, v in blocks[0].items()}


# --------------------------------------------------------------- layer plan
@dataclass(frozen=True)
class SubLayer:
    kind: str            # "attn" | "ssm" | "cross" | "attn_cross"
    window: int | None   # sliding window for attn
    use_moe: bool
    cap: float | None    # attn logit softcap


def block_plan(cfg: ArchConfig) -> list[SubLayer]:
    """Static layer composition of one block (same for every block)."""
    plan: list[SubLayer] = []
    for i in range(cfg.layers_per_block):
        use_moe = bool(cfg.n_experts) and (i % cfg.moe_every == cfg.moe_every - 1)
        if cfg.family == "encdec":
            # whisper decoder layer: self-attn + cross-attn + one MLP
            plan.append(SubLayer("attn_cross", None, use_moe, None))
        elif cfg.family == "ssm":
            plan.append(SubLayer("ssm", None, False, None))
        elif cfg.family == "hybrid":
            is_attn = i == cfg.layers_per_block - 1
            plan.append(SubLayer("attn" if is_attn else "ssm",
                                 cfg.sliding_window, use_moe, None))
        elif cfg.family == "vlm" and cfg.cross_attn_period and i == 0:
            plan.append(SubLayer("cross", None, use_moe, None))
        elif cfg.local_global_period:
            local = i % cfg.local_global_period == 0
            plan.append(SubLayer("attn",
                                 cfg.sliding_window if local else None,
                                 use_moe, cfg.attn_logit_softcap))
        else:
            plan.append(SubLayer("attn", cfg.sliding_window, use_moe,
                                 cfg.attn_logit_softcap))
    return plan


# -------------------------------------------------------------------- init
def _init_sublayer(key, sub: SubLayer, cfg: ArchConfig, dt) -> Params:
    has_ffn = sub.use_moe or cfg.d_ff > 0
    p: Params = {"norm1": torch.zeros((cfg.d_model,), dtype=dt)}
    if has_ffn:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dt)
    if sub.kind in ("attn", "cross", "attn_cross"):
        p["attn"] = init_attention(key, cfg, dt)
        if sub.kind == "cross":
            # gated residual (llama-vision)
            p["xgate"] = torch.zeros((), dtype=torch.float32)
        if sub.kind == "attn_cross":
            p["xattn"] = init_attention(key, cfg, dt)
            p["norm1x"] = torch.zeros((cfg.d_model,), dtype=dt)
    else:
        p["ssm"] = init_ssm(key, cfg, dt)
    if has_ffn:
        p["ffn"] = init_moe(key, cfg, dt) if sub.use_moe else init_mlp(key, cfg, dt)
    return p


def init_block(key, cfg: ArchConfig, dt) -> Params:
    return {f"l{i}": _init_sublayer(key, sub, cfg, dt)
            for i, sub in enumerate(block_plan(cfg))}


def _init_encoder_layer(key, cfg: ArchConfig, dt) -> Params:
    return {"norm1": torch.zeros((cfg.d_model,), dtype=dt),
            "norm2": torch.zeros((cfg.d_model,), dtype=dt),
            "attn": init_attention(key, cfg, dt),
            "ffn": init_mlp(key, cfg, dt)}


def init_params(key, cfg: ArchConfig) -> Params:
    """Random parameters on the CPU, drawn from ``key`` (a CPU
    ``torch.Generator``) in a fixed order."""
    dt = torch_dtype(cfg.dtype)
    V, D = cfg.vocab_size, cfg.d_model
    params: Params = {
        "embed": normal(key, (V, D), dt, D ** -0.5),
        "final_norm": torch.zeros((D,), dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(key, (D, V), dt, D ** -0.5)
    params["blocks"] = stack_blocks([init_block(key, cfg, dt)
                                     for _ in range(cfg.n_blocks)])
    if cfg.enc_layers:
        params["enc_blocks"] = stack_blocks([_init_encoder_layer(key, cfg, dt)
                                             for _ in range(cfg.enc_layers)])
        params["enc_norm"] = torch.zeros((D,), dtype=dt)
    return params


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree's shapes and dtypes as ``meta`` tensors (nothing
    is drawn or allocated)."""
    with torch.device("meta"):
        return init_params(None, cfg)


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) when
    gradients are being recorded."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------------------ encoder
def encoder_forward(params, enc_embed, cfg: ArchConfig, fetch=None):
    """Whisper-style bidirectional encoder over stub frame embeddings. Each
    layer is rematerialised under autograd, as the reference's always is,
    ``fetch`` (of ``"enc_blocks"``) inside it."""

    def layer(x, lp):
        if fetch is not None:
            lp = fetch(lp, "enc_blocks")
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attention(lp["attn"], h, h, cfg, causal=False, window=None,
                          cap=None)
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        return x + mlp(lp["ffn"], h, cfg.d_ff)

    x = enc_embed
    for lp in unstack_blocks(params["enc_blocks"]):
        x = _remat(layer, x, lp)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ------------------------------------------------------------------ forward
def _ffn(x, lp, sub: SubLayer, cfg: ArchConfig):
    if "ffn" not in lp:
        return x
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + (moe(lp["ffn"], h, cfg) if sub.use_moe
                else mlp(lp["ffn"], h, cfg.d_ff))


def _gate(lp, x):
    return torch.tanh(lp["xgate"]).to(x.dtype)


def _apply_sublayer(x, lp, sub: SubLayer, cfg: ArchConfig, memory, q_offset=0):
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if sub.kind == "ssm":
        x = x + ssd_apply(lp["ssm"], h, cfg)
    elif sub.kind == "cross":
        att = attention(lp["attn"], h, memory, cfg, causal=False, window=None,
                        cap=None)
        x = x + _gate(lp, x) * att
    else:
        x = x + attention(lp["attn"], h, h, cfg, causal=True,
                          window=sub.window, cap=sub.cap, q_offset=q_offset)
        if sub.kind == "attn_cross":
            hx = rms_norm(x, lp["norm1x"], cfg.norm_eps)
            x = x + attention(lp["xattn"], hx, memory, cfg, causal=False,
                              window=None, cap=None)
    return _ffn(x, lp, sub, cfg)


def embed(params, tokens, cfg: ArchConfig) -> torch.Tensor:
    """The token embeddings (B, S, D): from the rank's vocabulary rows
    (ids outside them give zeros, summed over ``model``) or its columns
    (gathered) where the table is split over ``model``."""
    table = params["embed"]
    if table.shape[0] < cfg.vocab_size:
        g = model_group()
        lo = tp.rank(g) * table.shape[0]
        ids = tokens.long() - lo
        inside = (ids >= 0) & (ids < table.shape[0])
        x = table[ids.clamp(0, table.shape[0] - 1)].masked_fill(~inside[..., None], 0)
        return tp.reduce(x, g)
    if table.shape[1] < cfg.d_model:
        return tp.gather(table[tokens], -1, model_group())
    return table[tokens]


def _logits(params, x, cfg: ArchConfig):
    """The logits of ``x``: the rank's vocabulary columns where the head
    (``lm_head``'s columns, or the tied embedding's rows) is split over
    ``model``; whole where it is replicated, or where the tied embedding is
    split by columns (partial sums over the rank's slice of ``x``,
    reduced)."""
    V = cfg.vocab_size
    if cfg.tie_embeddings:
        table = params["embed"]
        g = model_group() if table.shape != (V, cfg.d_model) else None
        if table.shape[0] < V:
            out = tp.copy(x, g) @ table.T
        else:
            out = out_proj(x, table.T, g, False)
    else:
        head = params["lm_head"]
        g = model_group() if head.shape[1] < V else None
        out = tp.copy(x, g) @ head
    return softcap(out, cfg.final_logit_softcap)


def whole_logits(logits, cfg: ArchConfig) -> torch.Tensor:
    """``logits`` with every vocabulary column: the ranks' columns gathered
    over ``model`` where they are split."""
    if logits.shape[-1] < cfg.vocab_size:
        return tp.gather(logits, -1, model_group())
    return logits


def forward(params, tokens, cfg: ArchConfig, memory=None, remat: bool = True,
            fetch=None):
    """Full-sequence logits: tokens (B, S) int32 -> (B, S, V). With
    ``remat`` each block keeps only its input for the backward pass and
    recomputes the rest (the reference's ``jax.checkpoint`` of the block);
    the values are the same either way. Gradients reach the stacked leaves
    through each block's views (:func:`unstack_blocks`). ``fetch`` runs
    inside the block: under ``remat`` the recompute fetches again and what
    it returns is not kept for the backward pass; without ``remat``
    autograd keeps every block's fetched tree (each block's gathered
    weights) until the backward pass."""
    plan = block_plan(cfg)

    def block(x, bp):
        if fetch is not None:
            bp = fetch(bp, "blocks")
        for i, sub in enumerate(plan):
            x = _apply_sublayer(x, bp[f"l{i}"], sub, cfg, memory)
        return x

    x = embed(params, tokens, cfg)
    for bp in unstack_blocks(params["blocks"]):
        x = _remat(block, x, bp) if remat else block(x, bp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)


# ------------------------------------------------------------------- caches
def init_cache(cfg: ArchConfig, batch: int, max_seq: int, memory=None,
               device=None) -> Params:
    """Per-block decode caches. Attention sublayers get (B, S_cache, K, hd)
    rings (S_cache = window if SWA else max_seq); SSM sublayers get O(1)
    recurrent state; cross sublayers get zeros here (memory K/V are
    computed from the stub embeddings at prefill and stored)."""
    dt = torch_dtype(cfg.dtype)
    plan = block_plan(cfg)
    K, hd = cfg.n_kv_heads, cfg.hd
    n = cfg.n_blocks

    def zeros(*shape):
        return torch.zeros((n, batch, *shape), dtype=dt, device=device)

    cache: Params = {}
    for i, sub in enumerate(plan):
        if sub.kind == "ssm":
            one = init_ssm_cache(cfg, batch, dt, device)
            cache[f"l{i}"] = {k: v.expand(n, *v.shape).clone()
                              for k, v in one.items()}
        elif sub.kind == "cross":
            S = max(1, cfg.n_vision_tokens)
            cache[f"l{i}"] = {"k": zeros(S, K, hd), "v": zeros(S, K, hd)}
        else:
            S = min(sub.window, max_seq) if sub.window else max_seq
            c = {"k": zeros(S, K, hd), "v": zeros(S, K, hd)}
            if sub.kind == "attn_cross":
                Se = max(1, cfg.enc_seq)
                c["xk"] = zeros(Se, K, hd)
                c["xv"] = zeros(Se, K, hd)
            cache[f"l{i}"] = c
    return {"blocks": cache,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int) -> Params:
    """The cache tree's shapes and dtypes as ``meta`` tensors."""
    return init_cache(cfg, batch, max_seq, device=torch.device("meta"))


# ------------------------------------------------------------------- decode
def decode_step(params, cache, token, cfg: ArchConfig, memory=None, fetch=None):
    """One decode step: token (B, 1) int32, cache from init_cache/prefill.

    Returns (logits (B, V), cache). The blocks' caches are written in
    place, one slot or state per sublayer through its view of the stacked
    leaf, and the cache returned holds the same tensors with ``pos`` + 1;
    clone the cache first to keep the one passed in. ``fetch`` maps each
    block's parameters before it runs. Under
    :func:`~repro_torch.models.layers.split_sequence` each attention
    sublayer, self and cross, attends on the rank's slice of its cache
    where its leaves are split."""
    plan = block_plan(cfg)
    pos = cache["pos"]
    x = embed(params, token, cfg)
    for b in range(cfg.n_blocks):
        bp = block_at(params["blocks"], b)
        if fetch is not None:
            bp = fetch(bp, "blocks")
        bc = block_at(cache["blocks"], b)
        for i, sub in enumerate(plan):
            lp, lc = bp[f"l{i}"], bc[f"l{i}"]
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if sub.kind == "ssm":
                out, _ = ssd_decode(lp["ssm"], h, lc, cfg)
                x = x + out
            elif sub.kind == "cross":
                att = _cross_decode(lp, h, lc, cfg, sequence_group(f"l{i}", "k"))
                x = x + _gate(lp, x) * att
            else:
                out, _, _ = decode_attention(lp["attn"], h, lc["k"], lc["v"],
                                             pos, cfg, window=sub.window,
                                             cap=sub.cap,
                                             seq=sequence_group(f"l{i}", "k"))
                x = x + out
                if sub.kind == "attn_cross":
                    hx = rms_norm(x, lp["norm1x"], cfg.norm_eps)
                    x = x + _cross_decode(
                        {"attn": lp["xattn"]}, hx,
                        {"k": lc["xk"], "v": lc["xv"]}, cfg,
                        sequence_group(f"l{i}", "xk"))
            x = _ffn(x, lp, sub, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = whole_logits(_logits(params, x, cfg)[:, 0], cfg)
    return logits, {"blocks": cache["blocks"], "pos": pos + 1}


def _cross_decode(lp, h, lc, cfg, seq=None):
    """Cross-attention against cached memory K/V (decode path); under a
    ``model`` axis, and on the rank's slice of a cache split along its
    sequence over ``seq``, as
    :func:`~repro_torch.models.layers.decode_attention` attends."""
    B = h.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    wq = lp["attn"]["wq"]
    g = model_group() if wq.shape[1] < H * hd else None
    q = tp.gather(tp.copy(h, g) @ wq, -1, g).reshape(B, H, hd)
    out = attend_cache(q, lc["k"], lc["v"], cfg, g=model_group(), seq=seq)
    return out_proj(out, lp["attn"]["wo"], g, False)


# ------------------------------------------------------------------ prefill
def prefill(params, tokens, cfg: ArchConfig, memory=None, max_seq=None, fetch=None):
    """Process a prompt, returning (last-position logits, filled caches).

    Caches are built by re-projecting K/V per block (the attention itself is
    the chunked path from `forward`). SSM blocks return their final state.
    The logits are those of position S-1 of every row, padding or not, as
    in the reference. ``fetch`` maps each block's parameters before it runs.
    """
    B, S = tokens.shape
    max_seq = max_seq or S
    plan = block_plan(cfg)
    x = embed(params, tokens, cfg)
    dt = torch_dtype(cfg.dtype)
    caches = []
    for b in range(cfg.n_blocks):
        bp = block_at(params["blocks"], b)
        if fetch is not None:
            bp = fetch(bp, "blocks")
        cache: Params = {}
        for i, sub in enumerate(plan):
            lp = bp[f"l{i}"]
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if sub.kind == "ssm":
                out, st = ssd_apply(lp["ssm"], h, cfg, return_state=True)
                x = x + out
                cache[f"l{i}"] = st
            elif sub.kind == "cross":
                att = attention(lp["attn"], h, memory, cfg, causal=False,
                                window=None, cap=None)
                x = x + _gate(lp, x) * att
                mk, mv = cache_kv(lp["attn"], memory, cfg, bias=False)
                cache[f"l{i}"] = {"k": mk.to(dt), "v": mv.to(dt)}
            else:
                x = x + attention(lp["attn"], h, h, cfg, causal=True,
                                  window=sub.window, cap=sub.cap)
                # re-project K/V into the ring cache layout
                kf, vf = cache_kv(lp["attn"], h, cfg, positions=torch.arange(
                    S, dtype=torch.int32, device=x.device))
                # a full-attention sublayer with S > max_seq takes the ring
                # branch too (Sc = max_seq), as in the reference
                Sc = min(sub.window, max_seq) if sub.window else max_seq
                if Sc >= S:
                    pad = (0, 0, 0, 0, 0, Sc - S)
                    c = {"k": F.pad(kf, pad).to(dt),
                         "v": F.pad(vf, pad).to(dt)}
                else:  # SWA ring: keep the last window, rotated to slot order
                    shift = S % Sc
                    c = {"k": torch.roll(kf[:, -Sc:], shift, dims=1).to(dt),
                         "v": torch.roll(vf[:, -Sc:], shift, dims=1).to(dt)}
                if sub.kind == "attn_cross":
                    hx = rms_norm(x, lp["norm1x"], cfg.norm_eps)
                    x = x + attention(lp["xattn"], hx, memory, cfg,
                                      causal=False, window=None, cap=None)
                    xk, xv = cache_kv(lp["xattn"], memory, cfg, bias=False)
                    c["xk"] = xk.to(dt)
                    c["xv"] = xv.to(dt)
                cache[f"l{i}"] = c
            x = _ffn(x, lp, sub, cfg)
        caches.append(cache)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = whole_logits(_logits(params, x, cfg)[:, 0], cfg)
    return logits, {"blocks": stack_blocks(caches),
                    "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
