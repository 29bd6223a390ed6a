"""The OnPair16 decode kernels.

* ``decode_compact`` (Algorithm 3 per string, ``csrc/onpair_decode.cu``): a
  group of 8 lanes per string over ragged rows. Two entries launch it:
  :func:`decode_rows`, the store's multiget (rows are strings of a token
  buffer on the device, picked by id, written into one packed output), and
  :func:`decode_compact`, the reference's padded contract. Plain versions:
  :func:`repro_torch.kernels.ref.decode_rows_ref` and
  :func:`repro_torch.kernels.ref.decode_batch_ref`.
* ``decode_tokens`` (full-stream decode): ``decode_all``, the store's
  ``scan`` and ``compact``; one call decodes one token stream into one byte
  stream (``csrc/onpair_decode_stream.cu``). Plain version:
  :func:`repro_torch.kernels.ref.decode_tokens_ref`.

For CPU tensors a wrapper runs the plain version; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, ref

#: most rows one launch of the rows kernel takes (its grid is in int)
MAX_ROWS = 1 << 30
_NO_LIMIT = 2**31 - 1


def _check_tables(name: str, mat16: torch.Tensor, lens: torch.Tensor,
                  dev: torch.device, lens_dtypes=(torch.int32,)) -> None:
    _build.expect("mat16", mat16, torch.uint8, 2, dev)
    if lens.dtype not in lens_dtypes:
        raise ValueError(f"{name}: lens must be one of {lens_dtypes}, got {lens.dtype}")
    _build.expect("lens", lens, lens.dtype, 1, dev)
    if mat16.shape[1] != 16 or lens.shape[0] != mat16.shape[0]:
        raise ValueError(f"{name}: shapes disagree: mat16 {tuple(mat16.shape)}, "
                         f"lens {tuple(lens.shape)}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and mat16.data_ptr() % 16:
        raise ValueError("mat16 rows must be 16-byte aligned (one uint4 load each)")


def _launch_rows(tokens, starts, ids, counts, max_count, out_start, mat16,
                 lens, out, out_len, M: int) -> None:
    """One launch of the rows kernel on the current stream (M >= 1)."""
    lib = _build.load()
    dev = tokens.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.onpair_decode_rows(
            tokens.data_ptr(), tokens.element_size(), tokens.numel(),
            starts.data_ptr(), starts.numel(),
            None if ids is None else ids.data_ptr(),
            None if counts is None else counts.data_ptr(), max_count,
            out_start.data_ptr(), mat16.data_ptr(), lens.data_ptr(),
            mat16.shape[0], out.data_ptr(), out.numel(), out_len.data_ptr(), M,
            stream)
    _build.check(rc, "decode_compact")
    _build.count(decode_compact)


def decode_rows(tokens: torch.Tensor, starts: torch.Tensor,
                out_start: torch.Tensor, out_size: int, mat16: torch.Tensor,
                lens: torch.Tensor, ids: torch.Tensor | None = None):
    """Decode M ragged rows into one packed byte buffer, M =
    ``out_start.numel() - 1``.

    tokens uint16[T] or int32[T] (ids < N), starts int64 (string i is
    ``tokens[starts[i] : starts[i + 1]]``), out_start int64[M + 1], mat16
    uint8[N, 16], lens int32[N]; ids int64[M] picks each row's string (row
    m is string m when None; an id outside ``[0, starts.numel() - 1)`` is a
    row of no tokens). ``out_size`` is ``out_start[M]``, which the
    caller knows without reading the device. Returns (out uint8[out_size],
    out_len int32[M]): row m is ``out[out_start[m] : out_start[m] +
    out_len[m]]``; no row writes outside ``[out_start[m], out_start[m +
    1])`` or outside ``out``, and ``out_len[m]`` is its full decoded
    length, so a row whose range is too short shows. Bytes no row wrote
    are unspecified. All inputs lie on one device: CUDA launches the kernel, the CPU runs
    :func:`~repro_torch.kernels.ref.decode_rows_ref`. ``M == 0`` returns
    without a launch.
    """
    dev = tokens.device
    if tokens.dtype not in (torch.uint16, torch.int32) or tokens.dim() != 1:
        raise ValueError("tokens must be uint16 or int32 with 1 dim, got "
                         f"{tokens.dtype} with shape {tuple(tokens.shape)}")
    _build.expect("tokens", tokens, tokens.dtype, 1, dev)
    _build.expect("starts", starts, torch.int64, 1, dev)
    _build.expect("out_start", out_start, torch.int64, 1, dev)
    _check_tables("decode_rows", mat16, lens, dev)
    M = out_start.shape[0] - 1
    if ids is not None:
        _build.expect("ids", ids, torch.int64, 1, dev)
    if M < 0 or M > MAX_ROWS or (ids is not None and ids.shape[0] != M) or (
            ids is None and starts.shape[0] < M + 1):
        raise ValueError(f"decode_rows: {M} rows disagree with ids or starts "
                         f"({starts.shape[0]} starts)")
    out_size = int(out_size)
    if out_size < 0:
        raise ValueError(f"decode_rows: out_size={out_size} must be >= 0")
    if dev.type == "cpu":
        return ref.decode_rows_ref(tokens, starts, out_start, out_size, mat16,
                                   lens, ids)
    out = torch.empty(out_size, dtype=torch.uint8, device=dev)
    out_len = torch.empty(M, dtype=torch.int32, device=dev)
    if M:
        _launch_rows(tokens, starts, ids, None, _NO_LIMIT, out_start, mat16,
                     lens, out, out_len, M)
    return out, out_len


def decode_compact(tokens: torch.Tensor, n_tokens: torch.Tensor,
                   mat16: torch.Tensor, lens: torch.Tensor):
    """Decode strings ``b`` = the first ``n_tokens[b]`` tokens of
    ``tokens[b]``: the reference's padded contract.

    tokens int32[B, T] (ids < N), n_tokens int32[B], mat16 uint8[N, 16],
    lens int32[N] (each <= 16) -> (out uint8[B, 16T + 16], out_len int32[B]);
    string b is ``out[b, :out_len[b]]`` and the bytes past it are
    unspecified. All four inputs lie on one device: CUDA launches the rows
    kernel with row b at token ``b*T`` and output ``b*(16T + 16)``, the CPU
    runs the plain version. ``B == 0`` returns empty outputs without a
    launch.
    """
    dev = tokens.device
    _build.expect("tokens", tokens, torch.int32, 2, dev)
    _build.expect("n_tokens", n_tokens, torch.int32, 1, dev)
    _check_tables("decode_compact", mat16, lens, dev)
    B, T = tokens.shape
    if n_tokens.shape[0] != B or B > MAX_ROWS:
        raise ValueError("decode_compact: shapes disagree: tokens "
                         f"{tuple(tokens.shape)}, n_tokens {tuple(n_tokens.shape)}")
    if dev.type == "cpu":
        return ref.decode_batch_ref(tokens, n_tokens, mat16, lens)
    W = 16 * T + 16
    out = torch.empty((B, W), dtype=torch.uint8, device=dev)
    out_len = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        starts = torch.arange(B, dtype=torch.int64, device=dev) * T
        out_start = torch.arange(B + 1, dtype=torch.int64, device=dev) * W
        _launch_rows(tokens.view(-1), starts, None, n_tokens, T, out_start,
                     mat16, lens, out, out_len, B)
    return out, out_len


#: launches of the rows kernel, from either entry (the smoke run zeroes it
#: before each path)
decode_compact.launches = 0

#: tokens per tile of the stream kernel (``kTile`` in its CUDA source)
_STREAM_TILE = 2048
#: the stream kernel's zeroed scratch (a ticket, a done counter, a status
#: word per tile) per (device, stream): each call leaves it zeroed, so calls
#: on one stream share it, and calls on two streams never do. Host threads
#: that launch on one stream (a service's worker and its caller) share it
#: too: their launches run one after another on the card
_stream_scratch: dict[tuple[int, int], torch.Tensor] = {}
_scratch_lock = threading.Lock()


def _scratch(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _scratch_lock:
        buf = _stream_scratch.get(key)
        if buf is None or buf.numel() < words:
            # a smaller buffer a launch still holds is freed to this stream
            # only, so no later allocation reuses it before that launch ends
            have = 0 if buf is None else buf.numel()
            buf = torch.zeros(max(words, 2 * have, 256), dtype=torch.int64, device=dev)
            _stream_scratch[key] = buf
        return buf


def decode_tokens(tokens: torch.Tensor, n_tokens: int, mat16: torch.Tensor,
                  lens: torch.Tensor, max_out: int):
    """Decode the token stream ``tokens[:n_tokens]`` into one byte stream.

    tokens uint16[T] or int32[T] (ids < N), ``n_tokens`` clamped to [0, T],
    mat16 uint8[N, 16], lens uint8[N] (each <= 16: a table small enough to
    stay in L1; the plain version also takes int32), ``max_out >= 0`` -> (out
    uint8[max_out], out_len int64 scalar tensor). ``out_len`` is the full
    decoded length; ``out`` holds the decoded bytes before ``max_out`` and
    zeros past ``out_len``. ``tokens`` may start anywhere in its buffer (a
    slice of the store's mirror does). All inputs lie on one device: CUDA
    launches the kernel (``csrc/onpair_decode_stream.cu``, one launch), the
    CPU runs the plain version. ``T == 0`` or ``n_tokens <= 0`` returns
    zeros without a launch.
    """
    dev = tokens.device
    if tokens.dtype not in (torch.uint16, torch.int32) or tokens.dim() != 1:
        raise ValueError("tokens must be uint16 or int32 with 1 dim, got "
                         f"{tokens.dtype} with shape {tuple(tokens.shape)}")
    _build.expect("tokens", tokens, tokens.dtype, 1, dev)
    _check_tables("decode_tokens", mat16, lens, dev, (torch.int32, torch.uint8))
    T = tokens.shape[0]
    n_tokens, max_out = int(n_tokens), int(max_out)
    if max_out < 0 or T >= 2**31:
        raise ValueError(f"decode_tokens: max_out={max_out} must be >= 0 and "
                         f"T={T} below 2**31")
    if dev.type == "cpu":
        return ref.decode_tokens_ref(tokens, n_tokens, mat16, lens, max_out)
    if lens.dtype != torch.uint8:
        raise ValueError(f"decode_tokens: the kernel reads uint8 lens, got {lens.dtype}")
    n = min(n_tokens, T)
    if n <= 0:
        return (torch.zeros(max_out, dtype=torch.uint8, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    out = torch.empty(max_out, dtype=torch.uint8, device=dev)
    out_len = torch.empty((), dtype=torch.int64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(dev, stream, (n + 16) // _STREAM_TILE + 3)
        rc = lib.onpair_decode_stream(
            tokens.data_ptr(), tokens.element_size(), mat16.data_ptr(),
            lens.data_ptr(), out.data_ptr(), out_len.data_ptr(), scratch.data_ptr(),
            scratch.numel(), T, n, max_out, stream)
    _build.check(rc, "decode_tokens")
    _build.count(decode_tokens)
    return out, out_len


#: wrapper calls that launched the kernel
decode_tokens.launches = 0
