"""The OnPair16 decode kernels.

* ``decode_compact`` (Algorithm 3 per string): the store's multiget path;
  one launch decodes a padded batch of token streams, one string per thread
  (``csrc/onpair_decode.cu``). Plain version:
  :func:`repro_torch.kernels.ref.decode_batch_ref`.
* ``decode_tokens`` (full-stream decode): ``decode_all``, the store's
  ``scan`` and ``compact``; one call decodes one token stream into one byte
  stream (``csrc/onpair_decode_stream.cu``). Plain version:
  :func:`repro_torch.kernels.ref.decode_tokens_ref`.

For CPU tensors a wrapper runs the plain version; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def decode_compact(tokens: torch.Tensor, n_tokens: torch.Tensor,
                   mat16: torch.Tensor, lens: torch.Tensor):
    """Decode strings ``b`` = the first ``n_tokens[b]`` tokens of
    ``tokens[b]``.

    tokens int32[B, T] (ids < N), n_tokens int32[B], mat16 uint8[N, 16],
    lens int32[N] (each <= 16) -> (out uint8[B, 16T + 16], out_len int32[B]);
    string b is ``out[b, :out_len[b]]`` and the bytes past it are
    unspecified. All four inputs lie on one device: CUDA launches the
    kernel, the CPU runs the plain version. ``B == 0`` returns empty
    outputs without a launch.
    """
    dev = tokens.device
    _build.expect("tokens", tokens, torch.int32, 2, dev)
    _build.expect("n_tokens", n_tokens, torch.int32, 1, dev)
    _build.expect("mat16", mat16, torch.uint8, 2, dev)
    _build.expect("lens", lens, torch.int32, 1, dev)
    B, T = tokens.shape
    if n_tokens.shape[0] != B or mat16.shape[1] != 16 or lens.shape[0] != mat16.shape[0]:
        raise ValueError("decode_compact: shapes disagree: tokens "
                         f"{tuple(tokens.shape)}, n_tokens {tuple(n_tokens.shape)}, "
                         f"mat16 {tuple(mat16.shape)}, lens {tuple(lens.shape)}")
    if dev.type == "cpu":
        return ref.decode_batch_ref(tokens, n_tokens, mat16, lens)
    if dev.type != "cuda":
        raise ValueError(f"decode_compact runs on cuda or cpu, not {dev}")
    if mat16.data_ptr() % 16:
        raise ValueError("mat16 rows must be 16-byte aligned (one uint4 load each)")
    W = 16 * T + 16
    out = torch.empty((B, W), dtype=torch.uint8, device=dev)
    out_len = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, out_len
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.onpair_decode_compact(
            tokens.data_ptr(), n_tokens.data_ptr(), mat16.data_ptr(),
            lens.data_ptr(), out.data_ptr(), out_len.data_ptr(), B, T, W, stream)
    _build.check(rc, "decode_compact")
    decode_compact.launches += 1
    return out, out_len


#: kernel launches so far (the smoke run zeroes it before the main path)
decode_compact.launches = 0

#: tokens per block of the stream kernel (``kTile`` in its CUDA source)
_STREAM_TILE = 1024


def decode_tokens(tokens: torch.Tensor, n_tokens: int, mat16: torch.Tensor,
                  lens: torch.Tensor, max_out: int):
    """Decode the token stream ``tokens[:n_tokens]`` into one byte stream.

    tokens int32[T] (ids < N), ``n_tokens`` clamped to [0, T], mat16
    uint8[N, 16], lens int32[N] (each <= 16), ``max_out >= 0`` -> (out
    uint8[max_out], out_len int64 scalar tensor). ``out_len`` is the full
    decoded length; ``out`` holds the decoded bytes before ``max_out`` and
    zeros past ``out_len``. All inputs lie on one device: CUDA launches the
    kernel (``csrc/onpair_decode_stream.cu``), the CPU runs the plain
    version. ``T == 0`` or ``n_tokens <= 0`` returns zeros without a launch.
    """
    dev = tokens.device
    _build.expect("tokens", tokens, torch.int32, 1, dev)
    _build.expect("mat16", mat16, torch.uint8, 2, dev)
    _build.expect("lens", lens, torch.int32, 1, dev)
    T = tokens.shape[0]
    n_tokens, max_out = int(n_tokens), int(max_out)
    if mat16.shape[1] != 16 or lens.shape[0] != mat16.shape[0]:
        raise ValueError("decode_tokens: shapes disagree: mat16 "
                         f"{tuple(mat16.shape)}, lens {tuple(lens.shape)}")
    if max_out < 0 or T >= 2**31:
        raise ValueError(f"decode_tokens: max_out={max_out} must be >= 0 and "
                         f"T={T} below 2**31")
    if dev.type == "cpu":
        return ref.decode_tokens_ref(tokens, n_tokens, mat16, lens, max_out)
    if dev.type != "cuda":
        raise ValueError(f"decode_tokens runs on cuda or cpu, not {dev}")
    if mat16.data_ptr() % 16:
        raise ValueError("mat16 rows must be 16-byte aligned (one uint4 load each)")
    n = min(n_tokens, T)
    if n <= 0:
        return (torch.zeros(max_out, dtype=torch.uint8, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    out = torch.empty(max_out, dtype=torch.uint8, device=dev)
    out_len = torch.empty((), dtype=torch.int64, device=dev)
    tile_sums = torch.empty(-(-n // _STREAM_TILE), dtype=torch.int64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.onpair_decode_stream(
            tokens.data_ptr(), mat16.data_ptr(), lens.data_ptr(),
            out.data_ptr(), out_len.data_ptr(), tile_sums.data_ptr(),
            T, n, max_out, stream)
    _build.check(rc, "decode_tokens")
    decode_tokens.launches += 1
    return out, out_len


#: wrapper calls that launched the kernel (its three passes count as one)
decode_tokens.launches = 0
