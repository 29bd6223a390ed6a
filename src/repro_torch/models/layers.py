"""Core neural layers: RMSNorm, RoPE, chunked GQA attention (SWA / softcap /
bias / cross / decode), SwiGLU MLP, and capacity-based MoE.

All layers are plain functions over parameter dicts of tensors (no module
framework — init functions mirror apply functions), with the reference's
names, keys and shapes. The sharding hooks read the mesh that
:func:`repro_torch.distributed.sharding.use_mesh` makes active
(``batch_axes``, the axis sizes); ``constrain`` stays the identity, because
the port's layers run on the rank's local tensors (see its docstring). A
step that splits the batch over the data axes says so with
:func:`split_batch`, and ``moe`` then routes over every rank's tokens; a
decode step whose KV caches are split along their sequence over ``data``
says so with :func:`split_sequence`, and attention then runs on the rank's
slots and combines its softmax over ``data`` (:func:`attend_cache`).

Tensor parallelism over ``model``: under a mesh whose ``model`` axis has
more than one rank, a weight the reference's rules shard over ``model``
reaches the layer as the rank's shard, and the layer reads which one from
its shape against the config's (the rules shard only what divides, so a
narrower leaf is a shard). The layers then compute on their shards as the
rules place them and issue the collectives of
:mod:`repro_torch.distributed.tp`: column-parallel ``wq``/``wk``/``wv``,
``w_gate``/``w_up`` and row-parallel ``wo``/``w_down`` with one all-reduce
after each row block; attention on the rank's query heads (against the KV
heads they read) where H divides, else on the rank's share of the query
sequence with every head (:func:`_layout`); experts split over ``model``
(EP) or each expert's hidden width split, and then their capacity slots
split over ``data``; decode against a cache whose head_dim lies over
``model`` (``cache_specs_tree``), the scores' partial sums all-reduced.

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

from repro_torch.distributed import tp

# ---------------------------------------------------------------- sharding
_MESH_CTX: list = [None]  # set by repro_torch.distributed.sharding.use_mesh
#: the process groups over which the running step split its batch, outer
#: axis first (``pod`` then ``data``), or None; set by :func:`split_batch`
_SPLIT_CTX: list = [None]
#: ``(group, split)`` of the running decode step, or None: the ``data``
#: group over which cache leaves are split along their sequence, and
#: which leaves are; set by :func:`split_sequence`
_SEQ_CTX: list = [None]


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


def model_group():
    """The ``model`` group of the active mesh, or None (no mesh, or one
    rank on the axis): the group :mod:`~repro_torch.distributed.tp`'s
    collectives run on."""
    return tp.group_of(_MESH_CTX[0])


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


@contextlib.contextmanager
def split_sequence(group, split: dict):
    """Mark the code inside as running on a rank's slice of the decode
    cache leaves that are split along their sequence over ``group`` (the
    ``data`` process group): ``split`` maps a sublayer's key in a block's
    cache (``"l3"``) to the names of its split leaves (``{"k", "v"}``,
    ``{"xk", "xv"}``). Rank r of ``group`` holds slots [r S_l, (r + 1) S_l)
    of a leaf whose global length is S = S_l d; the other leaves are whole
    on every rank (``cache_specs_tree`` decides leaf by leaf)."""
    _SEQ_CTX[0] = (group, split) if split else None
    try:
        yield
    finally:
        _SEQ_CTX[0] = None


def sequence_group(key: str, leaf: str):
    """The group over which the cache leaf ``leaf`` of sublayer ``key`` is
    split along its sequence under :func:`split_sequence`, or None."""
    ctx = _SEQ_CTX[0]
    return ctx[0] if ctx is not None and leaf in ctx[1].get(key, ()) else None


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


def _qkv(params, x, kv_x, cfg, g):
    """q, k and v of ``x`` and ``kv_x``, each the rank's column block where
    its weight is column-parallel (its input through ``tp.copy``), else
    whole; and whether q and k/v are blocks."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sq = params["wq"].shape[1] < H * hd
    skv = params["wk"].shape[1] < K * hd
    xf = tp.copy(x, g) if sq else x
    # a replicated weight takes the input itself: its gradient is whole
    kvf = (xf if kv_x is x else tp.copy(kv_x, g)) if skv else kv_x
    q = xf @ params["wq"]
    k = kvf @ params["wk"]
    v = kvf @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v, sq, skv


def _layout(cfg, sq: bool, skv: bool, Sq: int, chunk_q: int, g) -> str:
    """How a rank of the ``model`` group ``g`` shares attention's work, by
    the reference's rules (``src/repro/models/layers.py`` ``attention``):

    * ``"heads"``: H and K divide over ``model``; the rank's column blocks
      hold its whole query heads and the KV heads they read;
    * ``"query"``: H divides and K does not (GQA); the rank attends with its
      query heads against the KV heads they read, K/V built whole;
    * ``"seq"``: H does not divide (H = K too); on the single-block path
      with Sq a multiple of the axis and longer than it, the rank attends
      its Sq/m queries with every head, K/V built whole;
    * ``"whole"``: anything else (no ``model`` axis, or Sq that cannot be
      split); q/k/v gathered, every head on every rank."""
    if g is None or not sq:
        return "whole"
    m = tp.size(g)
    if cfg.n_heads % m == 0:
        return "heads" if skv and cfg.n_kv_heads % m == 0 else "query"
    if Sq <= chunk_q and Sq % m == 0 and Sq > m:
        return "seq"
    return "whole"


def _shared(t: torch.Tensor, split: bool, g) -> torch.Tensor:
    """K or V whole on every rank of ``g`` (gathered where ``split``), for
    work each rank does differently: its gradient is summed over ``g``
    before the rank's columns are cut from it."""
    return tp.copy(tp.gather(t, -1, g) if split else t, g)


def _kv_for(k: torch.Tensor, h0: int, n: int, rep: int) -> torch.Tensor:
    """The KV head (dim 2 of ``k``) that each of query heads ``h0 .. h0 +
    n - 1`` reads (head h reads h // rep), one for each query head."""
    return k.index_select(2, torch.arange(h0, h0 + n, device=k.device) // rep)


def out_proj(out, wo, g, rows: bool) -> torch.Tensor:
    """``out @ wo``; for a row-parallel ``wo`` (narrower than ``out``'s
    heads), ``out`` is the rank's rows when ``rows``, else cut to them, and
    the partial sums are reduced over ``model``."""
    if wo.shape[0] == out.shape[-1] and not rows:
        return out @ wo
    if not rows:
        out = tp.scatter(out, -1, g)
    return tp.reduce(out @ wo, g)


def attention(params, x, kv_x, cfg, *, causal: bool, window: int | None,
              cap: float | None, q_offset=0, chunk_q: int | None = None,
              positions_k=None) -> torch.Tensor:
    """Chunked multi-head attention.

    x: (B, Sq, D) queries source; kv_x: (B, Sk, D) keys/values source
    (kv_x is x for self-attention, encoder/vision memory for cross).
    q_offset: absolute position of x[0] (decode/prefill continuation).
    Under a ``model`` axis each rank does its share as :func:`_layout`
    says, and its output is the rank's rows of the row-parallel ``wo``.
    """
    B, Sq, D = x.shape
    Sk = kv_x.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = model_group()
    q, k, v, sq, skv = _qkv(params, x, kv_x, cfg, g)
    if chunk_q is None:
        # one block up to 8k queries, 1k-query chunks beyond
        chunk_q = Sq if Sq <= 8192 else 1024
    layout = _layout(cfg, sq, skv, Sq, chunk_q, g)
    q0 = 0                               # the rank's first query
    if layout == "whole":
        q = tp.gather(q, -1, g) if sq else q
        k, v = (tp.gather(k, -1, g), tp.gather(v, -1, g)) if skv else (k, v)
    elif layout == "query":
        k, v = _shared(k, skv, g), _shared(v, skv, g)
    elif layout == "seq":
        # the column block over every query -> every column over Sq/m
        q = tp.all_to_all(q, 1, -1, g)
        k, v = _shared(k, skv, g), _shared(v, skv, g)
        q0 = tp.rank(g) * q.shape[1]
    Sl = q.shape[1]
    q = q.reshape(B, Sl, q.shape[-1] // hd, hd)
    k = k.reshape(B, Sk, k.shape[-1] // hd, hd)
    v = v.reshape(B, Sk, v.shape[-1] // hd, hd)
    qpos = q_offset + q0 + torch.arange(Sl, dtype=torch.int32, device=x.device)
    kpos = (positions_k if positions_k is not None
            else torch.arange(Sk, dtype=torch.int32, device=x.device))
    if causal:  # RoPE only on self-attention paths
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, kpos, cfg.rope_theta)
    if layout == "query":                # the KV heads the rank's heads read
        Hl = q.shape[2]
        k, v = (_kv_for(t, tp.rank(g) * Hl, Hl, H // K) for t in (k, v))
    if Sl % chunk_q != 0:
        # non-multiple sequence (e.g. whisper's 1500 frames): largest
        # divisor <= chunk_q keeps the chunks exact without padding
        chunk_q = next(c for c in range(min(chunk_q, Sl), 0, -1) if Sl % c == 0)
    if Sl <= chunk_q:
        out = _attend_block(q, k, v, qpos, kpos, causal, window, cap)
    else:
        out = torch.cat([_attend_block(q[:, c0 : c0 + chunk_q], k, v,
                                       qpos[c0 : c0 + chunk_q], kpos, causal,
                                       window, cap)
                         for c0 in range(0, Sl, chunk_q)], dim=1)
    out = out.reshape(B, Sl, -1)
    if layout == "seq":                  # back to the column block over Sq
        out = tp.all_to_all(out, -1, 1, g)
    return out_proj(out, params["wo"], g, layout != "whole")


def cache_kv(params, src, cfg, positions=None, bias: bool | None = None):
    """K and V of ``src`` (B, S, D) as the decode cache holds them,
    (B, S, K, hd), RoPE'd at ``positions`` when given and biased when
    ``bias`` (by default ``cfg.qkv_bias``). Under a ``model`` axis they are
    the rank's head_dim slice where head_dim divides over it, as
    ``cache_specs_tree`` places the cache: an all-to-all from the rank's
    whole KV heads, or a cut of every head gathered."""
    g = model_group()
    m = tp.size(g)
    B, S, _ = src.shape
    K, hd = cfg.n_kv_heads, cfg.hd
    skv = params["wk"].shape[1] < K * hd
    srcf = tp.copy(src, g) if skv else src
    k = srcf @ params["wk"]
    v = srcf @ params["wv"]
    if cfg.qkv_bias if bias is None else bias:
        k, v = k + params["bk"], v + params["bv"]
    whole = skv and K % m == 0
    if skv and not whole:
        k, v = tp.gather(k, -1, g), tp.gather(v, -1, g)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    if positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    if g is not None and hd % m == 0:            # head_dim over model
        if whole:
            return tp.all_to_all(k, 3, 2, g), tp.all_to_all(v, 3, 2, g)
        return tp.part(k, hd // m, g), tp.part(v, hd // m, g)
    if whole:                                     # the cache holds every head
        return tp.gather(k, 2, g), tp.gather(v, 2, g)
    return k, v


def attend_cache(q, cache_k, cache_v, cfg, *, valid=None, cap=None, g=None, seq=None):
    """One query token of every head, q (B, H, hd), against a cache
    (B, S, K, hd_l); ``valid`` (S,) masks slots. Where the cache holds the
    rank's head_dim slice (hd_l < hd), the scores are that slice's partial
    sums, reduced over ``model``, and the output's slices are gathered.
    Where the cache is the rank's slice of a sequence split over ``seq``
    (:func:`split_sequence`), the softmax is combined over ``seq`` by three
    all-reduces: the maximum of the ranks' row maxima, the sum of their
    exponentials, and the sum of the ranks' PV products in fp32 (each
    taken of the probabilities cast to the query dtype, as the whole
    softmax's are), cast once; a rank whose slots are all masked adds
    exact zeros. Returns (B, 1, H * hd)."""
    B, H, hd = q.shape
    K, hd_l = cache_k.shape[2], cache_k.shape[3]
    qh = tp.part(q, hd_l, g).reshape(B, K, H // K, hd_l)
    scores = torch.einsum("bkrh,bskh->bkrs", qh, cache_k).float()
    if hd_l < hd:
        scores = tp.reduce(scores, g)
    scores = scores * (hd ** -0.5)
    scores = softcap(scores, cap)
    if valid is not None:
        scores = scores.masked_fill(~valid[None, None, None], -1e30)
    if seq is None:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkrs,bskh->bkrh", probs, cache_v)
    else:
        top = tp.all_max(scores.amax(-1, keepdim=True), seq)
        e = torch.exp(scores - top)
        probs = (e / tp.reduce(e.sum(-1, keepdim=True), seq)).to(q.dtype)
        out = torch.einsum("bkrs,bskh->bkrh", probs.float(), cache_v.float())
        out = tp.reduce(out, seq).to(q.dtype)
    if hd_l < hd:
        out = tp.gather(out, -1, g)
    return out.reshape(B, 1, H * hd)


def decode_attention(params, x, cache_k, cache_v, pos, cfg, *,
                     window: int | None, cap: float | None, seq=None):
    """Single-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, K, hd); pos: int32 scalar tensor
    (current write index). Returns (out (B,1,D), cache_k, cache_v).

    The slot is written as the reference's ``dynamic_update_slice`` writes
    it, start index clamped to [0, S_max - 1]: with full attention and
    ``pos >= S_max`` the token overwrites slot ``S_max - 1``. The write is
    in place: the caches returned are the tensors passed in, one slot
    changed. Under a ``model`` axis the cache is the rank's head_dim slice
    (``cache_specs_tree``): the rank writes that slice of the new token's
    K/V (the small q/k/v gathered from the column blocks) and attends as
    :func:`attend_cache` does. Where the cache is the rank's slice of a
    sequence split over ``seq`` (:func:`split_sequence`), S_max is the
    global length, the slot and the mask are in global indices, only the
    rank that holds the slot changes it (the row is written back as it was
    elsewhere: no branch on ``pos`` and no host sync), and the softmax is
    combined over ``seq``.
    """
    B, _, D = x.shape
    S_l = cache_k.shape[1]
    S = S_l * tp.size(seq)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = model_group()
    q, k, v, sq, skv = _qkv(params, x, x, cfg, g)
    q = tp.gather(q, -1, g) if sq else q
    k, v = (tp.gather(k, -1, g), tp.gather(v, -1, g)) if skv else (k, v)
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
    hd_l = cache_k.shape[-1]
    k, v = tp.part(k, hd_l, g).to(cache_k.dtype), tp.part(v, hd_l, g).to(cache_v.dtype)
    first = tp.rank(seq) * S_l                   # the rank's first slot
    if seq is not None:
        own = (slot >= first) & (slot < first + S_l)
        slot = (slot - first).clamp(0, S_l - 1)
        k = torch.where(own, k, cache_k.index_select(1, slot))
        v = torch.where(own, v, cache_v.index_select(1, slot))
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    kidx = torch.arange(first, first + S_l, dtype=torch.int32, device=x.device)
    if window is not None:
        valid = kidx < torch.clamp(pos + 1, max=S)
    else:
        valid = kidx <= pos
    out = attend_cache(q.reshape(B, H, hd), cache_k, cache_v, cfg, valid=valid,
                       cap=cap, g=g, seq=seq)
    return out_proj(out, params["wo"], g, False), cache_k, cache_v


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


def mlp(params, x, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU. ``d_ff`` is the hidden width: a ``w_gate`` narrower than it
    is the rank's column block, with ``w_up``'s and ``w_down``'s matching
    row block, and the output is reduced over ``model``."""
    cols = d_ff is not None and params["w_gate"].shape[1] < d_ff
    g = model_group() if cols else None
    xf = tp.copy(x, g)
    h = F.silu(xf @ params["w_gate"])
    h = h * (xf @ params["w_up"])
    return tp.reduce(h @ params["w_down"], g)


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


def _capacity_group(E: int, C: int):
    """The ``data`` group over which ``moe`` splits its C capacity slots,
    or None: under a batch split over ``data`` of more than one rank (with
    a ``pod`` axis of any size beside it), where the experts do not divide
    over ``model`` and C divides over ``data`` (the reference's
    ``cap_ax``)."""
    groups = _SPLIT_CTX[0]
    d = _mesh_axis_size("data")
    if not groups or d == 1 or E % _mesh_axis_size("model") == 0 or C % d:
        return None
    return groups[-1]                    # the innermost axis: data


def _experts(params, eb: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their buffers ``eb`` (El, slots, D)."""
    h = F.silu(torch.bmm(eb, params["w_gate"]))
    h = h * torch.bmm(eb, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _dispatch(rows: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
              Cb: int, El: int, K: int, by_index: bool) -> torch.Tensor:
    """The rank's block (El, Cb, D) of capacity slots: each slot holds the
    row of ``rows`` (K assignments a row, in row order) whose assignment
    (``expert``, ``slot``: its slot in the block, or ``Cb`` where it has
    none here) it was given, and zeros where none was. ``by_index``: a
    scatter of row indices and a gather of the rows (the reference's form
    at T >= 4096); else a scatter of the payload."""
    D = rows.shape[1]
    dev = rows.device
    if by_index:
        tok = torch.arange(expert.shape[0], device=dev) // K     # source row
        slot_tok = torch.full((El, Cb + 1), rows.shape[0], dtype=torch.int64, device=dev)
        slot_tok[expert, slot] = tok
        pad = torch.cat([rows, torch.zeros((1, D), dtype=rows.dtype, device=dev)])
        return pad[slot_tok[:, :Cb]]
    buf = torch.zeros((El, Cb + 1, D), dtype=rows.dtype, device=dev)
    buf[expert, slot] = torch.repeat_interleave(rows, K, dim=0)
    return buf[:, :Cb]


def _collect(out_e: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
             mine: torch.Tensor, gates: torch.Tensor, K: int, group) -> torch.Tensor:
    """The rows' outputs (T, D) in ``out_e``'s dtype: the slot outputs
    ``out_e`` (El, Cb, D) read by the assignments ``mine`` of the block,
    weighed by their ``gates`` (in ``out_e``'s dtype) and summed over each
    row's K. Where ``group`` is None that sum is the row's output (torch sums
    the K terms in fp32 and rounds once). Else the rows are those of every
    rank of ``group``: their sums stay fp32 partials, summed over ``group``
    (each rank keeping its own rows) and rounded once, as the one-device
    call rounds (the other ranks' terms are exact zeros); the gradient goes
    back in ``out_e``'s dtype, which holds it exactly."""
    D = out_e.shape[2]
    got = out_e[expert, torch.clamp(slot, max=out_e.shape[1] - 1)]  # (T*K, D)
    got = got.masked_fill(~mine[:, None], 0.0) * gates.reshape(-1)[:, None]
    if group is None:
        return got.reshape(-1, K, D).sum(dim=1)
    part = got.float().reshape(-1, K, D).sum(1)
    return tp.reduce_rows(part, group, out_e.dtype).to(out_e.dtype)


def moe(params, x, cfg) -> torch.Tensor:
    """Capacity-bucketed top-k MoE (GShard-style, scatter/gather form).

    Tokens pick top_k experts; assignments beyond each expert's capacity are
    dropped (standard capacity-factor semantics), in the order of a stable
    sort of the assignments by expert, as in the reference. Under
    :func:`split_batch` the capacity and the slots are those of the whole
    batch, so a rank keeps and drops what the one-device call would; its
    expert buffers hold only its own tokens (the other slots stay zero).
    Under a ``model`` axis every rank of a ``model`` group routes the same
    tokens; it runs its block of experts where they are split over
    ``model`` (E divides), else every expert on its columns of the hidden
    width, and the combined output is summed over ``model``. Where the
    experts do not divide and C divides over ``data`` (``_capacity_group``,
    with or without a ``pod`` axis), data rank r runs the experts on slots
    [r C/d, (r+1) C/d) only: the token rows of its pod's d data shares come
    to it by one all-gather over ``data`` (``tp.gather_rows``, the gates
    beside them), it fills its block from the assignments of those tokens
    (``_dispatch``; a slot of another pod's token stays zero, and that
    pod's rank of the same data index fills it), and the weighted outputs
    go back as fp32 partial sums of the pod's tokens, reduce-scattered
    over ``data`` (``_collect``). No rank builds, sends or receives an
    (El, C, D) buffer there.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    ep = params["w_gate"].shape[0] < E                   # experts over model
    sharded = ep or params["w_gate"].shape[2] < cfg.d_ff  # or each one's width
    g = model_group() if sharded else None
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                   # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # the experts' inputs and gates: their gradients are the rank's share
    xe, gate_vals = tp.copy(xt, g), tp.copy(gate_vals, g)

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
    cap = _capacity_group(E, C)
    El = params["w_gate"].shape[0]
    if cap is not None:
        # the rank's C/d slots, filled from the rows of its pod's d shares
        # (the gates as x's dtype beside them): no expert is split over
        # model here; a slot of another pod's token stays zero
        d = tp.size(cap)
        Cb = C // d
        c0 = tp.rank(cap) * Cb
        rows = tp.gather_rows(torch.cat([xe, gate_vals.to(x.dtype)], 1), cap)
        pod = slice(share // d * d * A, (share // d + 1) * d * A)
        expert, slot = all_expert[pod], slot[pod]
        mine = (slot >= c0) & (slot < c0 + Cb)
        slot = torch.where(mine, slot - c0, Cb)                  # else dump column Cb
        xe, gates = rows[:, :D], rows[:, D:]
    else:
        # this share's assignments; dropped ones land in dump column C, as
        # do, under EP, those to other ranks' experts (the rank's block of E/m)
        Cb, expert, slot = C, flat_expert, slot[share * A : (share + 1) * A]
        mine = slot < C
        slot = torch.where(mine, slot, C)
        if ep:
            e0 = tp.rank(g) * El
            here = (flat_expert >= e0) & (flat_expert < e0 + El)
            mine = mine & here
            expert = torch.where(here, flat_expert - e0, 0)
            slot = torch.where(here, slot, C)
        gates = gate_vals.to(x.dtype)
    eb = _dispatch(xe, expert, slot, Cb, El, K, T_all >= 4096)
    out_e = _experts(params, eb)                                 # (El, Cb, D)
    combined = _collect(out_e, expert, slot, mine, gates, K, cap)
    # the rank's experts' (or hidden columns') share of every token's output
    return tp.reduce(combined, g).reshape(B, S, D)
