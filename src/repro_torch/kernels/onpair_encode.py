"""``encode_batch``: the OnPair16 greedy longest-prefix-match parse kernel.

The write path: one launch parses a padded batch of strings against the
frozen dictionary's static LPM tables, a warp per string with the lanes
sharing each token's probes and bucket walk, on a grid over every string of
the batch (``csrc/onpair_encode.cu``). For CPU tensors the wrapper runs the
plain version, :func:`repro_torch.kernels.ref.encode_batch_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import DeviceDict

#: table arrays in the launcher's argument order
_TABLES = ("s_lo", "s_hi", "s_len", "s_tok", "p_lo", "p_hi", "p_len",
           "p_bucket", "bucket_start", "bucket_size", "suf_lo", "suf_hi",
           "suf_len", "suf_tok")


def encode_batch(data: torch.Tensor, lens: torch.Tensor, dd: DeviceDict,
                 max_tokens: int):
    """Parse string ``b`` = ``data[b, :lens[b]]`` into token ids.

    data uint8[B, L + 16] zero padded (lens clamped to [0, L]), lens
    int32[B], ``dd`` on the same device -> (tokens int32[B, max_tokens],
    n_tokens int32[B]). The parse stops quietly at ``max_tokens``; each token
    row's tail is zero. CUDA launches the kernel, the CPU runs the plain
    version. ``B == 0`` returns empty outputs without a launch.
    """
    dev = data.device
    _build.expect("data", data, torch.uint8, 2, dev)
    _build.expect("lens", lens, torch.int32, 1, dev)
    for name in _TABLES:
        _build.expect(f"dd.{name}", getattr(dd, name), torch.int32, 1, dev)
    B, Lp = data.shape
    if lens.shape[0] != B or Lp < 16 or max_tokens < 0:
        raise ValueError(f"encode_batch: data {tuple(data.shape)} needs 16 "
                         f"bytes of padding, lens {tuple(lens.shape)} one "
                         f"length per row, max_tokens={max_tokens} >= 0")
    if dev.type == "cpu":
        return ref.encode_batch_ref(data, lens, dd, max_tokens)
    if dev.type != "cuda":
        raise ValueError(f"encode_batch runs on cuda or cpu, not {dev}")
    tokens = torch.empty((B, max_tokens), dtype=torch.int32, device=dev)
    n_tokens = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return tokens, n_tokens
    lib = _build.load()
    # rows read as aligned u32 words when their stride and base allow it
    aligned = Lp % 4 == 0 and data.data_ptr() % 4 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.onpair_encode_batch(
            data.data_ptr(), lens.data_ptr(),
            *(getattr(dd, name).data_ptr() for name in _TABLES),
            tokens.data_ptr(), n_tokens.data_ptr(),
            B, Lp, max_tokens, dd.s_lo.shape[0], dd.p_lo.shape[0],
            dd.s_probe_max, dd.p_probe_max, dd.max_bucket, int(aligned), stream)
    _build.check(rc, "encode_batch")
    _build.count(encode_batch)
    return tokens, n_tokens


#: kernel launches so far (the smoke run zeroes it before the main path)
encode_batch.launches = 0
