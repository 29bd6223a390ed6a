"""Host <-> device bridge over the OnPair16 kernels.

Bridges host-side types (a frozen dictionary, ``list[bytes]``, ragged token
arrays) to the padded device layouts the kernels take, and back. Used by the
codec (:mod:`repro_torch.core.codec`) and the store's multiget path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import PackedDictionary
from repro_torch.device import resolve_device
from repro_torch.kernels import onpair_decode, onpair_encode
from repro_torch.kernels.ref import DeviceDict
from repro_torch.obs import REGISTRY, TRACER, Counter

#: device decode invocations by path — the CUDA kernel, or the plain
#: PyTorch version a CPU device runs
_DECODE_BATCHES = {
    path: REGISTRY.register(Counter("repro_kernel_decode_batches_total",
                                    labels={"path": path}))
    for path in ("cuda", "ref")
}

#: geometric byte-length bucket capacities of the bucketed encode path;
#: grown by doubling when a longer string arrives
_ENCODE_LEN_BUCKETS = (32, 128, 512)
#: batch dimension of every bucketed encode launch
_ENCODE_PAD_BATCH = 64


def pack_strings(strings: list[bytes], pad_len: int | None = None,
                 pad_extra: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """list[bytes] -> (data uint8[B, L + pad_extra] zero padded, lens int32[B])."""
    L = pad_len if pad_len is not None else max((len(s) for s in strings), default=1)
    data = np.zeros((len(strings), L + pad_extra), dtype=np.uint8)
    lens = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        if len(s) > L:
            raise ValueError(f"string {i} has {len(s)} bytes > pad_len={L}")
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    return data, lens


def pack_token_matrix(token_lists: list[np.ndarray], pad_tokens: int | None = None,
                      pad_batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Ragged token streams -> padded (tokens int32[B, T], n_tokens int32[B]).

    ``pad_tokens``/``pad_batch`` pin T and B to the store's length buckets.
    Padding rows/tails are zeros with n_tokens masking them out.
    """
    B = pad_batch if pad_batch is not None else len(token_lists)
    if B < len(token_lists):
        raise ValueError(f"pad_batch={B} < batch of {len(token_lists)}")
    T = pad_tokens if pad_tokens is not None else max(
        (len(t) for t in token_lists), default=1)
    T = max(T, 1)
    tokens = np.zeros((B, T), dtype=np.int32)
    n_tokens = np.zeros(B, dtype=np.int32)
    for i, t in enumerate(token_lists):
        if len(t) > T:
            raise ValueError(f"stream {i} has {len(t)} tokens > pad_tokens={T}")
        tokens[i, : len(t)] = t
        n_tokens[i] = len(t)
    return tokens, n_tokens


class OnPairDevice:
    """OnPair16 encode and decode on one device, over a frozen dictionary.

    ``dictionary`` is a :class:`PackedDictionary` (uploaded here) or a
    :class:`DeviceDict` already on ``device``.
    """

    def __init__(self, dictionary: PackedDictionary | DeviceDict,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if isinstance(dictionary, DeviceDict):
            if dictionary.device.type != self.device.type:
                raise ValueError(f"dictionary tables are on {dictionary.device}, "
                                 f"not {self.device}")
            self.dd = dictionary
        else:
            if not dictionary.variant16:
                raise ValueError("the device kernels decode OnPair16 "
                                 "(entries of at most 16 bytes)")
            self.dd = DeviceDict.build(dictionary, self.device)
        self._path = "cuda" if self.device.type == "cuda" else "ref"
        # every launch uses a (encode_pad_batch, cap + 16) shape drawn from
        # encode_len_caps, as in the reference's bucketed encode
        self.encode_len_caps: list[int] = list(_ENCODE_LEN_BUCKETS)
        self.encode_pad_batch: int = _ENCODE_PAD_BATCH

    # ----------------------------------------------------------- encode
    def encode_batch(self, strings: list[bytes], max_tokens: int | None = None,
                     pad_len: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Compress a batch; returns (tokens int32[B, T], n_tokens int32[B])."""
        data, lens = pack_strings(strings, pad_len=pad_len)
        if max_tokens is None:
            max_tokens = data.shape[1] - 16 or 1
        toks, n = onpair_encode.encode_batch(
            torch.from_numpy(data).to(self.device),
            torch.from_numpy(lens).to(self.device), self.dd, max_tokens)
        return toks.cpu().numpy(), n.cpu().numpy()

    def _encode_cap(self, n: int) -> int:
        """Smallest bucket capacity >= n bytes, growing the set by doubling."""
        for cap in self.encode_len_caps:
            if n <= cap:
                return cap
        cap = self.encode_len_caps[-1]
        while cap < n:
            cap *= 2
            self.encode_len_caps.append(cap)
        return cap

    def encode_bucketed(self, strings: list[bytes]) -> list[np.ndarray]:
        """Batch encode in a bounded set of shapes.

        Strings are grouped into geometric byte-length buckets; each group is
        padded (with empty rows) to ``encode_pad_batch`` and encoded at the
        shape (pad_batch, cap + 16) with ``max_tokens = cap`` (one token per
        byte is the worst case). Returns the int32 token arrays in input order.
        """
        out: list[np.ndarray] = [None] * len(strings)  # type: ignore[list-item]
        pb = self.encode_pad_batch
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(strings):
            groups.setdefault(self._encode_cap(max(len(s), 1)), []).append(i)
        for cap, idxs in sorted(groups.items()):
            for k in range(0, len(idxs), pb):
                sel = idxs[k : k + pb]
                chunk = [strings[i] for i in sel] + [b""] * (pb - len(sel))
                toks, n = self.encode_batch(chunk, max_tokens=cap, pad_len=cap)
                for j, i in enumerate(sel):
                    out[i] = toks[j, : n[j]]
        return out

    def encode_to_bytes(self, strings: list[bytes]) -> list[bytes]:
        return [t.astype("<u2").tobytes() for t in self.encode_bucketed(strings)]

    # ----------------------------------------------------------- decode
    def decode_batch(self, tokens: np.ndarray, n_tokens: np.ndarray) -> list[bytes]:
        """Batched random-access decode: tokens int32[B, T] -> list[bytes]."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        n_tokens = np.ascontiguousarray(n_tokens, dtype=np.int32)
        if tokens.size and (tokens.min() < 0 or tokens.max() >= self.dd.num_entries):
            raise ValueError(f"token ids must lie in [0, {self.dd.num_entries})")
        _DECODE_BATCHES[self._path].inc()
        with TRACER.span("kernel.decode_batch", path=self._path,
                         shape=list(tokens.shape)):
            out, olen = onpair_decode.decode_compact(
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(n_tokens).to(self.device),
                self.dd.mat16, self.dd.lens)
            out, olen = out.cpu().numpy(), olen.cpu().numpy()
        return [out[i, : olen[i]].tobytes() for i in range(out.shape[0])]

    def multiget_decode(self, token_lists: list[np.ndarray],
                        pad_tokens: int | None = None,
                        pad_batch: int | None = None) -> list[bytes]:
        """Batched random-access decode of ragged token streams: assembles the
        padded (B, T) matrix (see :func:`pack_token_matrix`) and runs the
        per-string decode kernel once. Returns only the real rows."""
        tokens, n_tokens = pack_token_matrix(token_lists, pad_tokens, pad_batch)
        return self.decode_batch(tokens, n_tokens)[: len(token_lists)]
