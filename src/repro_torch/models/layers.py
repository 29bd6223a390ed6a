"""Core neural layers: RMSNorm, RoPE, chunked GQA attention (SWA / softcap /
bias / cross / decode), SwiGLU MLP, and capacity-based MoE.

All layers are plain functions over parameter dicts of tensors (no module
framework — init functions mirror apply functions), with the reference's
names, keys and shapes. The sharding hooks read the mesh that
:func:`repro_torch.distributed.sharding.use_mesh` makes active
(``batch_axes``, the axis sizes); ``constrain`` stays the identity, because
the port's layers run on the rank's local tensors (see its docstring). A
step that splits the batch over the data axes says so with
:func:`split_batch`, and ``moe`` then routes over every rank's tokens.

Attention is *query-chunked*: scores are materialised one (chunk_q, S) slab
at a time (a Python loop over query blocks), O(S·chunk) live memory instead
of O(S²). Masks are computed from index arithmetic (never a (S, S) tensor).

Numerics follow the reference: RMSNorm scales by ``1 + scale`` in fp32 and
casts back, RoPE's frequencies are computed in numpy float32, scores and
softmax run in fp32, and the probabilities are cast to the query dtype
before the PV product. Randomly initialised weights come from a CPU
``torch.Generator`` (``key``), drawn in fp32 and cast to the layer dtype, so
the card and the host get the same weights for one seed.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------- sharding
_MESH_CTX: list = [None]  # set by repro_torch.distributed.sharding.use_mesh
#: the process groups over which the running step split its batch, outer
#: axis first (``pod`` then ``data``), or None; set by :func:`split_batch`
_SPLIT_CTX: list = [None]


def set_mesh_context(mesh) -> None:
    _MESH_CTX[0] = mesh


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain mapping, in
    the mesh's axis order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {str(k): int(v) for k, v in dict(mesh).items()}


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """The identity, inside a mesh context too. The reference's
    ``with_sharding_constraint`` tells GSPMD how to lay out a global array;
    the port's layers only ever see the rank's local tensors (the mesh step
    gathers the parameters and hands each rank its share of the batch), so
    there is nothing to constrain."""
    return x


def batch_axes(mesh=None) -> tuple:
    """The composite data-parallel axis set present in the ambient mesh."""
    mesh = mesh if mesh is not None else _MESH_CTX[0]
    if mesh is None:
        return (None,)
    names = mesh_shape(mesh)
    return (tuple(a for a in ("pod", "data") if a in names),)


def _mesh_axis_size(name: str) -> int:
    mesh = _MESH_CTX[0]
    if mesh is None:
        return 1
    return int(mesh_shape(mesh).get(name, 1))


@contextlib.contextmanager
def split_batch(groups):
    """Mark the code inside as running on one rank's share of a batch split
    over ``groups`` (process groups, outer axis first; the shares in rank
    order, outer axis major). ``moe`` then takes its capacity and slots from
    the tokens of every share, as the reference's SPMD program does."""
    _SPLIT_CTX[0] = list(groups) or None
    try:
        yield
    finally:
        _SPLIT_CTX[0] = None


def _gather_shares(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` of every share of the split batch, concatenated along dim 0 in
    share order, and this rank's share index. Without a split: ``x``, 0."""
    groups = _SPLIT_CTX[0]
    if not groups:
        return x, 0
    import torch.distributed as dist

    index = 0
    for g in reversed(groups):  # innermost axis first: outer-axis-major order
        n = dist.get_world_size(g)
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=g)
        x = out
    scale = 1
    for g in reversed(groups):
        index += dist.get_rank(g) * scale
        scale *= dist.get_world_size(g)
    return x, index


# ------------------------------------------------------------------ random
def normal(key: torch.Generator | None, shape, dtype: torch.dtype,
           scale: float = 1.0) -> torch.Tensor:
    """Standard normal draws from ``key`` (a CPU generator) in fp32, scaled,
    then cast to ``dtype``; with no key, an empty tensor of that shape and
    dtype on the default device (``meta`` for :func:`abstract_params
    <repro_torch.models.transformer.abstract_params>`)."""
    if key is None:
        return torch.empty(shape, dtype=dtype)
    return torch.randn(shape, generator=key, dtype=torch.float32).mul_(
        scale).to(dtype)


# ----------------------------------------------------------------- helpers
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


@functools.lru_cache(maxsize=64)
def _rope_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's frequencies, computed in numpy float32 as the reference does
    (a float64 or torch pow rounds differently, and theta = 1e6 drifts)."""
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(np.asarray(freq, dtype=np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    ang = positions[..., :, None].float() * _rope_freq(half, theta, x.device)
    # ang: (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention
def init_attention(key, cfg, layer_dtype) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = D ** -0.5
    p = {
        "wq": normal(key, (D, H * hd), layer_dtype, s),
        "wk": normal(key, (D, K * hd), layer_dtype, s),
        "wv": normal(key, (D, K * hd), layer_dtype, s),
        "wo": normal(key, (H * hd, D), layer_dtype, s),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=layer_dtype)
        p["bk"] = torch.zeros((K * hd,), dtype=layer_dtype)
        p["bv"] = torch.zeros((K * hd,), dtype=layer_dtype)
    return p


def _attend_block(q, k, v, qpos, kpos, causal, window, cap):
    """Scores for one q chunk against full K/V. q: (B,Qc,H,hd),
    k/v: (B,S,K,hd) — GQA repeats kv heads on the fly."""
    B, Qc, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    rep = H // K
    qh = q.reshape(B, Qc, K, rep, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qh, k).float()
    scores = scores * (hd ** -0.5)
    scores = softcap(scores, cap)
    dq = qpos[:, None]
    dk = kpos[None, :]
    mask = torch.ones((Qc, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= dk <= dq
    if window is not None:
        mask &= dk > dq - window
    scores = scores.masked_fill(~mask[None, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(B, Qc, H, hd)


def attention(params, x, kv_x, cfg, *, causal: bool, window: int | None,
              cap: float | None, q_offset=0, chunk_q: int | None = None,
              positions_k=None) -> torch.Tensor:
    """Chunked multi-head attention.

    x: (B, Sq, D) queries source; kv_x: (B, Sk, D) keys/values source
    (kv_x is x for self-attention, encoder/vision memory for cross).
    q_offset: absolute position of x[0] (decode/prefill continuation).
    """
    B, Sq, D = x.shape
    Sk = kv_x.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = kv_x @ params["wk"]
    v = kv_x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, Sq, H, hd)
    k = k.reshape(B, Sk, K, hd)
    v = v.reshape(B, Sk, K, hd)
    qpos = q_offset + torch.arange(Sq, dtype=torch.int32, device=x.device)
    kpos = (positions_k if positions_k is not None
            else torch.arange(Sk, dtype=torch.int32, device=x.device))
    if causal:  # RoPE only on self-attention paths
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, kpos, cfg.rope_theta)
    if chunk_q is None:
        # one block up to 8k queries, 1k-query chunks beyond
        chunk_q = Sq if Sq <= 8192 else 1024
    if Sq % chunk_q != 0:
        # non-multiple sequence (e.g. whisper's 1500 frames): largest
        # divisor <= chunk_q keeps the chunks exact without padding
        chunk_q = next(c for c in range(min(chunk_q, Sq), 0, -1) if Sq % c == 0)
    if Sq <= chunk_q:
        out = _attend_block(q, k, v, qpos, kpos, causal, window, cap)
    else:
        out = torch.cat([_attend_block(q[:, c0 : c0 + chunk_q], k, v,
                                       qpos[c0 : c0 + chunk_q], kpos, causal,
                                       window, cap)
                         for c0 in range(0, Sq, chunk_q)], dim=1)
    return out.reshape(B, Sq, H * hd) @ params["wo"]


def decode_attention(params, x, cache_k, cache_v, pos, cfg, *,
                     window: int | None, cap: float | None):
    """Single-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, K, hd); pos: int32 scalar tensor
    (current write index). Returns (out (B,1,D), cache_k, cache_v).

    The slot is written as the reference's ``dynamic_update_slice`` writes
    it, start index clamped to [0, S_max - 1]: with full attention and
    ``pos >= S_max`` the token overwrites slot ``S_max - 1``. The write is
    in place: the caches returned are the tensors passed in, one slot
    changed.
    """
    B, _, D = x.shape
    S = cache_k.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, 1, H, hd)
    k = k.reshape(B, 1, K, hd)
    v = v.reshape(B, 1, K, hd)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    posv = pos.reshape(1)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    # SWA: rotate the physical cache slot; full: slot == pos (clamped)
    slot = pos % S if window is not None else pos
    slot = slot.clamp(0, S - 1).to(torch.int64).reshape(1)
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    rep = H // K
    qh = q.reshape(B, K, rep, hd)
    scores = torch.einsum("bkrh,bskh->bkrs", qh, cache_k).float()
    scores = scores * (hd ** -0.5)
    scores = softcap(scores, cap)
    kidx = torch.arange(S, dtype=torch.int32, device=x.device)
    if window is not None:
        valid = kidx < torch.clamp(pos + 1, max=S)
    else:
        valid = kidx <= pos
    scores = scores.masked_fill(~valid[None, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrs,bskh->bkrh", probs, cache_v).reshape(B, 1, H * hd)
    return out @ params["wo"], cache_k, cache_v


# ----------------------------------------------------------------- MLP / MoE
def init_mlp(key, cfg, layer_dtype, d_ff=None) -> dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    s = D ** -0.5
    return {
        "w_gate": normal(key, (D, Fd), layer_dtype, s),
        "w_up": normal(key, (D, Fd), layer_dtype, s),
        "w_down": normal(key, (Fd, D), layer_dtype, Fd ** -0.5),
    }


def mlp(params, x) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"])
    h = h * (x @ params["w_up"])
    return h @ params["w_down"]


def init_moe(key, cfg, layer_dtype) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = D ** -0.5
    return {
        "router": normal(key, (D, E), torch.float32, s),
        "w_gate": normal(key, (E, D, Fd), layer_dtype, s),
        "w_up": normal(key, (E, D, Fd), layer_dtype, s),
        "w_down": normal(key, (E, Fd, D), layer_dtype, Fd ** -0.5),
    }


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices, in
    descending order, ties broken by the lower index (``lax.top_k``'s
    order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params, x, cfg) -> torch.Tensor:
    """Capacity-bucketed top-k MoE (GShard-style, scatter/gather form).

    Tokens pick top_k experts; assignments beyond each expert's capacity are
    dropped (standard capacity-factor semantics), in the order of a stable
    sort of the assignments by expert, as in the reference. Under
    :func:`split_batch` the capacity and the slots are those of the whole
    batch, so a rank keeps and drops what the one-device call would; its
    expert buffers hold only its own tokens (the other slots stay zero).
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                   # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    flat_expert = expert_idx.reshape(-1)                      # (T*K,)
    # capacity and slots come from the tokens of the whole batch: under a
    # batch split, every share's routing (ints) is gathered first
    all_expert, share = _gather_shares(flat_expert)
    T_all = all_expert.shape[0] // K
    C = int(np.ceil(T_all * K / E * cfg.capacity_factor))
    C = max(8, min(C, T_all))
    # position of each assignment within its expert's bucket, via a stable
    # sort (jnp.argsort is stable; the drops below depend on this order)
    A = flat_expert.shape[0]
    sorted_idx = torch.argsort(all_expert, stable=True)
    sorted_exp = all_expert[sorted_idx]
    counts = torch.zeros((E,), dtype=all_expert.dtype, device=dev).index_add_(
        0, all_expert, torch.ones_like(all_expert))          # bincount, also on meta
    starts = torch.cumsum(counts, 0) - counts                 # (E,)
    pos_sorted = torch.arange(all_expert.shape[0], device=dev) - starts[sorted_exp]
    slot = torch.zeros(all_expert.shape, dtype=torch.int64, device=dev)
    slot[sorted_idx] = pos_sorted
    slot = slot[share * A : (share + 1) * A]                  # this share's
    keep = slot < C
    # dropped assignments land in dump column C
    wslot = torch.where(keep, slot, C)
    if T_all >= 4096:
        # scatter of token indices, then a gather of their rows
        assign_tok = torch.arange(A, device=dev) // K         # source token
        slot_tok = torch.full((E, C + 1), T, dtype=torch.int64, device=dev)
        slot_tok[flat_expert, wslot] = assign_tok
        xt_pad = torch.cat([xt, torch.zeros((1, D), dtype=x.dtype, device=dev)])
        eb = xt_pad[slot_tok[:, :C]]                          # (E, C, D)
    else:
        # decode-sized T: scatter the payload directly
        src = torch.repeat_interleave(xt, K, dim=0)           # (T*K, D)
        buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=dev)
        buf[flat_expert, wslot] = src
        eb = buf[:, :C]
    h = F.silu(torch.bmm(eb, params["w_gate"]))
    h = h * torch.bmm(eb, params["w_up"])
    out_e = torch.bmm(h, params["w_down"])                    # (E, C, D)
    gathered = out_e[flat_expert, torch.clamp(slot, max=C - 1)]  # (T*K, D)
    gathered = gathered.masked_fill(~keep[:, None], 0.0)
    weighted = gathered * gate_vals.reshape(-1)[:, None].to(x.dtype)
    combined = weighted.reshape(T, K, D).sum(dim=1)
    return combined.reshape(B, S, D)
