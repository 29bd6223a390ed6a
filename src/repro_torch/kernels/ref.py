"""Device tables and the plain PyTorch versions of the OnPair16 kernels.

These are the same functions as the CUDA kernels, written with torch ops:
the CPU tests run them against the JAX reference, and the smoke run on the
card holds each kernel against them. A batch dimension is written out where
the reference used ``vmap``, and a step loop replaces ``while_loop``.

Integer convention: packed u32 values are held as int64 masked to 32 bits
(torch has no ``>>`` and no indexing for uint32 on the CPU), and the device
tables keep u32 arrays as int32 tensors holding the same bits, which is what
the CUDA kernels read as ``uint32_t``. Every hash is bit-identical to
:func:`repro_torch.core.packed.hash_key`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch.core.packed import PackedDictionary

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32), split so no int64
    product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """murmur3-style finaliser on int64 tensors (or ints) holding u32 values."""
    x = _mul32(x & _M32, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_key(lo, hi, length):
    return mix32(lo ^ mix32(hi ^ mix32(length)))


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of u32 values held in int64 (32 for x == 0):
    the popcount of ``(x & -x) - 1``, by the SWAR bit count, in integers
    only (a float log2 is not exact on every device)."""
    x = x & _M32
    v = ((x & -x) - 1) & _M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def shared_prefix_bytes(lo1, hi1, lo2, hi2) -> torch.Tensor:
    """Algorithm 2 on (lo, hi) u32 pairs: number of matching low-order bytes."""
    dlo = (lo1 ^ lo2) & _M32
    dhi = (hi1 ^ hi2) & _M32
    return torch.where(dlo != 0, (ctz32(dlo) >> 3).clamp(max=4),
                       4 + (ctz32(dhi) >> 3).clamp(max=4))


# ------------------------------------------------------------- device tables
#: reference PackedDictionary fields the device path reads, by storage type
_U32_FIELDS = ("s_lo", "s_hi", "p_lo", "p_hi", "suf_lo", "suf_hi")
_I32_FIELDS = ("lens", "s_len", "s_tok", "p_len", "p_bucket", "bucket_start",
               "bucket_size", "suf_len", "suf_tok")
ARRAY_FIELDS = ("mat16",) + _I32_FIELDS + _U32_FIELDS


@dataclass(frozen=True)
class DeviceDict:
    """A frozen OnPair16 dictionary uploaded as tensors on one device."""

    # decode
    mat16: torch.Tensor       # uint8[N, 16]
    lens: torch.Tensor        # int32[N], every value <= 16
    # short tier (open addressing, power-of-two size S)
    s_lo: torch.Tensor        # int32[S] holding u32 bits
    s_hi: torch.Tensor
    s_len: torch.Tensor       # int32[S] (0 = empty)
    s_tok: torch.Tensor       # int32[S]
    # long tier (open addressing over 8-byte prefixes, size P)
    p_lo: torch.Tensor        # int32[P] holding u32 bits
    p_hi: torch.Tensor
    p_len: torch.Tensor       # int32[P] (0 = empty, 8 = occupied)
    p_bucket: torch.Tensor    # int32[P]
    bucket_start: torch.Tensor
    bucket_size: torch.Tensor
    suf_lo: torch.Tensor      # int32[M] holding u32 bits
    suf_hi: torch.Tensor
    suf_len: torch.Tensor     # int32[M]
    suf_tok: torch.Tensor     # int32[M]
    # probe and scan bounds
    s_probe_max: int
    p_probe_max: int
    max_bucket: int

    @staticmethod
    def from_arrays(arrays: dict, *, s_probe_max: int, p_probe_max: int,
                    max_bucket: int, device: torch.device) -> "DeviceDict":
        """Validate host arrays (the fields of a PackedDictionary) and upload
        them to ``device``."""
        missing = [k for k in ARRAY_FIELDS if k not in arrays]
        if missing:
            raise ValueError(f"dictionary arrays lack {missing}")
        mat16 = np.asarray(arrays["mat16"])
        if mat16.ndim != 2 or mat16.shape[1] != 16:
            raise ValueError(f"mat16 must be [N, 16], got {mat16.shape}")
        if mat16.size and (mat16.min() < 0 or mat16.max() > 255):
            raise ValueError("mat16 must hold byte values")
        lens = np.asarray(arrays["lens"])
        if lens.shape != (mat16.shape[0],) or (lens.size and (
                lens.min() < 1 or lens.max() > 16)):
            raise ValueError("the device kernels decode OnPair16: one length "
                             "in 1..16 per mat16 row")
        for table in ("s", "p"):
            size = np.asarray(arrays[f"{table}_lo"]).size
            if size < 1 or size & (size - 1):
                raise ValueError(f"{table}_* table size {size} is not a power of two")
        if min(s_probe_max, p_probe_max, max_bucket) < 0:
            raise ValueError("probe and bucket bounds must be >= 0")

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        tensors = {"mat16": put(mat16.astype(np.uint8, copy=False))}
        tensors.update({k: put(np.asarray(arrays[k]).astype(np.int32, copy=False))
                        for k in _I32_FIELDS})
        tensors.update({k: put(np.asarray(arrays[k]).astype(np.uint32, copy=False)
                               .view(np.int32))
                        for k in _U32_FIELDS})
        return DeviceDict(**tensors, s_probe_max=int(s_probe_max),
                          p_probe_max=int(p_probe_max), max_bucket=int(max_bucket))

    @staticmethod
    def build(d: PackedDictionary, device: torch.device) -> "DeviceDict":
        return DeviceDict.from_arrays(
            {k: getattr(d, k) for k in ARRAY_FIELDS},
            s_probe_max=d.s_probe_max, p_probe_max=d.p_probe_max,
            max_bucket=max(1, d.max_bucket_size), device=device)

    @property
    def device(self) -> torch.device:
        return self.mat16.device

    @property
    def num_entries(self) -> int:
        return self.mat16.shape[0]

    def entries(self) -> list[bytes]:
        """The dictionary's entries, read back from the tables: row ``i`` of
        ``mat16`` cut to ``lens[i]`` (OnPair16 entries fit their row)."""
        rows = self.mat16.cpu().numpy().tobytes()
        lens = self.lens.cpu().numpy().tolist()
        return [rows[16 * i : 16 * i + n] for i, n in enumerate(lens)]

    @property
    def nbytes(self) -> int:
        """Bytes the tables occupy on the device."""
        return sum(t.nbytes for t in (getattr(self, f.name) for f in fields(self))
                   if isinstance(t, torch.Tensor))


# ============================================================ decode
def decode_batch_ref(tokens: torch.Tensor, n_tokens: torch.Tensor,
                     mat16: torch.Tensor, lens: torch.Tensor):
    """Plain version of ``decode_compact``: tokens int32[B, T] -> (out
    uint8[B, 16T + 16], out_len int32[B]).

    ``out[b, :out_len[b]]`` is string b: the first ``lens[tok]`` bytes of each
    of its first ``n_tokens[b]`` (clamped to [0, T]) tokens' ``mat16`` rows,
    concatenated. Bytes past ``out_len`` are zero here and unspecified in
    the kernel. Built as a gather of rows plus one masked scatter (exclusive
    prefix sum of the lengths gives each row's start).
    """
    decode_batch_ref.calls += 1
    B, T = tokens.shape
    dev = tokens.device
    out = torch.zeros((B, 16 * T + 16), dtype=torch.uint8, device=dev)
    valid = torch.arange(T, device=dev) < n_tokens.to(torch.int64)[:, None]
    tok = torch.where(valid, tokens.to(torch.int64), 0)
    tl = torch.where(valid, lens.to(torch.int64)[tok], 0)          # [B, T]
    starts = tl.cumsum(1) - tl
    j = torch.arange(16, device=dev)
    mask = j < tl[..., None]                                       # [B, T, 16]
    col = (starts[..., None] + j)[mask]
    row = torch.arange(B, device=dev)[:, None, None].expand(B, T, 16)[mask]
    out[row, col] = mat16[tok][mask]
    return out, tl.sum(1).to(torch.int32)


decode_batch_ref.calls = 0


def token_ids(tokens: torch.Tensor) -> torch.Tensor:
    """uint16 or int32 token ids as int64 (uint16 through an int16 view, so
    no uint16 arithmetic is needed on any device)."""
    if tokens.dtype == torch.uint16:
        return tokens.view(torch.int16).to(torch.int64) & 0xFFFF
    return tokens.to(torch.int64)


def decode_rows_ref(tokens: torch.Tensor, starts: torch.Tensor,
                    out_start: torch.Tensor, out_size: int, mat16: torch.Tensor,
                    lens: torch.Tensor, ids: torch.Tensor | None = None):
    """Plain version of ``decode_rows``: M ragged rows -> (out
    uint8[out_size], out_len int32[M]), M = ``out_start.numel() - 1``.

    Row m is string ``id = ids[m]`` (``m`` when ids is None): its tokens
    ``tokens[starts[id] : starts[id + 1]]`` (none when the end is before
    the start, or when ``id`` is outside ``[0, starts.numel() - 1)``). Each token writes the first ``clamp(lens[tok], 0, 16)``
    bytes of its ``mat16`` row at the row's cursor, which then moves by that
    length; bytes at or past ``out_start[m + 1] - out_start[m]`` are
    dropped, so a row never writes outside its range, nor outside ``out``.
    Tokens past the buffer and ids outside the dictionary decode to
    nothing. ``out_len[m]`` is the row's full decoded length; bytes of the
    output no row wrote are zero here and unspecified in the kernel. A
    gather of every row's tokens, a prefix sum per row, and one masked
    scatter.
    """
    decode_rows_ref.calls += 1
    dev = tokens.device
    M = out_start.shape[0] - 1
    N = mat16.shape[0]
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    sid = ids if ids is not None else torch.arange(M, device=dev)
    S = starts.shape[0]
    has = (sid >= 0) & (sid < S - 1)                 # ids with a string
    sid = torch.where(has, sid, 0)
    s = n = torch.zeros_like(sid)
    if S:
        s = torch.where(has, starts[sid], 0)
        n = torch.where(has, starts[(sid + 1).clamp(max=S - 1)] - s, 0).clamp(min=0)
    row = torch.repeat_interleave(torch.arange(M, device=dev), n)
    first = n.cumsum(0) - n
    idx = s[row] + torch.arange(row.numel(), device=dev) - first[row]
    T = tokens.shape[0]
    valid = (idx >= 0) & (idx < T)
    tok = token_ids(tokens)[idx.clamp(0, max(T - 1, 0))] if T else idx
    valid &= (tok >= 0) & (tok < N)
    tok = torch.where(valid, tok, 0)
    tl = torch.where(valid, lens.to(torch.int64)[tok].clamp(0, 16), 0) if N else \
        torch.zeros_like(tok)
    ex = tl.cumsum(0) - tl
    pos = ex - ex[first[row]]                       # start inside the row
    j = torch.arange(16, device=dev)
    base = out_start[:-1]
    room = torch.minimum(out_start[1:] - base, out_size - base)  # bytes a row may write
    room = torch.where((base < 0) | (base > out_size), 0, room)
    dst = base[row][:, None] + pos[:, None] + j
    mask = (j < tl[:, None]) & (pos[:, None] + j < room[row][:, None])
    if N:
        out[dst[mask]] = mat16[tok][mask]
    out_len = torch.zeros(M, dtype=torch.int64, device=dev).index_add_(0, row, tl)
    return out, out_len.to(torch.int32)


decode_rows_ref.calls = 0


def decode_tokens_ref(tokens: torch.Tensor, n_tokens: int, mat16: torch.Tensor,
                      lens: torch.Tensor, max_out: int):
    """Plain version of ``decode_tokens``: one token stream -> (out
    uint8[max_out], out_len int64 scalar tensor).

    The first ``n_tokens`` (clamped to [0, T]) tokens of ``tokens``
    (uint16[T] or int32[T]) decode to the first ``lens[tok]`` bytes of each
    one's ``mat16`` row, concatenated; ``out_len`` is their total length and ``out`` holds the
    bytes before ``max_out``, zero past ``out_len``. The counterpart of the
    reference's ``decode_ref``: a gather of rows and lengths, an exclusive
    prefix sum, and one masked scatter.
    """
    decode_tokens_ref.calls += 1
    T = tokens.shape[0]
    dev = tokens.device
    n = min(max(int(n_tokens), 0), T)
    tok = token_ids(tokens[:n])
    tl = lens.to(torch.int64)[tok]
    starts = tl.cumsum(0) - tl
    j = torch.arange(16, device=dev)
    idx = starts[:, None] + j
    mask = (j < tl[:, None]) & (idx < max_out)
    out = torch.zeros(max_out, dtype=torch.uint8, device=dev)
    out[idx[mask]] = mat16[tok][mask]
    return out, tl.sum()


decode_tokens_ref.calls = 0


# ============================================================ encode
def _byte_mask(nbytes: torch.Tensor) -> torch.Tensor:
    """u32 mask covering the low min(nbytes, 4) bytes (0 if nbytes <= 0)."""
    nb = nbytes.clamp(0, 4)
    return torch.where(nb >= 4, _M32, (1 << (nb * 8)) - 1)


def _first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index of the first True along the last dim, whether any is True)."""
    return mask.to(torch.uint8).argmax(-1, keepdim=True), mask.any(-1)


def _probe(lo, hi, length, t_lo, t_hi, t_len, t_pay, probe_max: int):
    """Linear-probe an open-addressing table for (lo, hi, length) keys of any
    shape; returns the payload, or -1. Probing stops at the first empty
    slot (len == 0) and after ``probe_max`` probes."""
    if probe_max < 1:
        return torch.full_like(lo, -1)
    mask = t_lo.shape[0] - 1
    i = torch.arange(probe_max, device=lo.device)
    slots = ((hash_key(lo, hi, length) & mask)[..., None] + i) & mask
    sl = t_len[slots]
    hit = ((sl == length[..., None]) & (t_lo[slots] == lo[..., None])
           & (t_hi[slots] == hi[..., None]))
    first, any_stop = _first_true(hit | (sl == 0))
    found = any_stop & hit.gather(-1, first).squeeze(-1)
    return torch.where(found, t_pay[slots].gather(-1, first).squeeze(-1), -1)


def _pack4(win: torch.Tensor, at: int) -> torch.Tensor:
    """Little-endian u32 of bytes ``win[:, at:at+4]`` (int64)."""
    return (win[:, at] | (win[:, at + 1] << 8) | (win[:, at + 2] << 16)
            | (win[:, at + 3] << 24))


def _lpm_search(win: torch.Tensor, rem: torch.Tensor, t: dict, dd: DeviceDict):
    """Algorithm 1 for K positions at once: ``win`` int64[K, 16] holds the 16
    bytes at each position (zero-padded past the string), ``rem`` the bytes
    left. Returns (token int64[K], match length int64[K])."""
    lo1, hi1, lo2, hi2 = (_pack4(win, at) for at in (0, 4, 8, 12))
    dev = win.device

    # ---- long tier: 8-byte prefix probe, then the bucket's suffixes in
    # descending length order; the first that fits and matches wins ----
    bucket = _probe(lo1, hi1, torch.full_like(rem, 8), t["p_lo"], t["p_hi"],
                    t["p_len"], t["p_bucket"], dd.p_probe_max)
    use_long = (rem > 8) & (bucket >= 0)
    b = bucket.clamp(min=0)
    size = torch.where(use_long, t["bucket_size"][b], 0).clamp(max=dd.max_bucket)
    k = torch.arange(max(int(size.max()), 1), device=dev)  # widest bucket hit
    in_range = k < size[:, None]
    i = torch.where(in_range, t["bucket_start"][b][:, None] + k, 0)
    s_len = t["suf_len"][i]
    hit = (in_range & (s_len <= (rem - 8)[:, None])
           & (shared_prefix_bytes(lo2[:, None], hi2[:, None], t["suf_lo"][i],
                                  t["suf_hi"][i]) >= s_len))
    first, any_hit = _first_true(hit)
    ltok = torch.where(any_hit, t["suf_tok"][i].gather(-1, first).squeeze(-1), -1)
    lmlen = 8 + s_len.gather(-1, first).squeeze(-1)
    long_found = ltok >= 0

    # ---- short tier: lengths min(rem, 8) .. 1, masking lo/hi to each ----
    length = rem.clamp(max=8)[:, None] - torch.arange(8, device=dev)   # [K, 8]
    cand = _probe(lo1[:, None] & _byte_mask(length),
                  hi1[:, None] & _byte_mask(length - 4), length,
                  t["s_lo"], t["s_hi"], t["s_len"], t["s_tok"], dd.s_probe_max)
    first, any_hit = _first_true((length >= 1) & (cand >= 0))
    stok = torch.where(any_hit, cand.gather(-1, first).squeeze(-1), 0)
    smlen = torch.where(any_hit, length.gather(-1, first).squeeze(-1), 1)

    return (torch.where(long_found, ltok, stok),
            torch.where(long_found, lmlen, smlen))


def encode_batch_ref(data: torch.Tensor, lens: torch.Tensor, dd: DeviceDict,
                     max_tokens: int):
    """Plain version of ``encode_batch``: greedy longest-prefix-match parse
    of each row of ``data`` uint8[B, L + 16] (zero padded; string b is
    ``data[b, :lens[b]]``, lens clamped to [0, L]).

    Returns (tokens int32[B, max_tokens], n_tokens int32[B]); the parse stops
    quietly at ``max_tokens`` and the tail of each token row is zero.
    """
    encode_batch_ref.calls += 1
    B, Lp = data.shape
    dev = data.device
    tokens = torch.zeros((B, max_tokens), dtype=torch.int32, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    t = {k: getattr(dd, k).to(torch.int64) & _M32 if k in _U32_FIELDS
         else getattr(dd, k).to(torch.int64)
         for k in _U32_FIELDS + _I32_FIELDS if k != "lens"}
    d = data.to(torch.int64)
    str_len = lens.to(torch.int64).clamp(0, Lp - 16)
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    j16 = torch.arange(16, device=dev)
    for step in range(max_tokens):
        act = torch.nonzero(pos < str_len).squeeze(1)
        if act.numel() == 0:
            break
        p = pos[act]
        tok, mlen = _lpm_search(d[act[:, None], p[:, None] + j16],
                                str_len[act] - p, t, dd)
        tokens[act, step] = tok.to(torch.int32)
        pos[act] += mlen
        n[act] += 1
    return tokens, n


encode_batch_ref.calls = 0
