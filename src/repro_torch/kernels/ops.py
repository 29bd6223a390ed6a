"""Host <-> device bridge over the OnPair16 kernels.

Bridges host-side types (a frozen dictionary, ``list[bytes]``, ragged token
arrays, string ids) to the device layouts the kernels take, and back. Used
by the codec (:mod:`repro_torch.core.codec`) and the store's multiget, scan
and write paths.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.packed import PackedDictionary
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, onpair_decode, onpair_encode
from repro_torch.kernels.ref import DeviceDict, token_ids
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
#: most strings a bucketed encode launch takes: about 8x the 8,448 warps an
#: H100 holds at once (132 SMs x 64), a warp per string; a length group of
#: more strings goes up in chunks of this many, the last chunk unpadded
_ENCODE_PAD_BATCH = 1 << 16
#: most padded input bytes, strings x (cap + 16), one encode launch takes;
#: a launch's buffers come to about 6x this (the bytes, the int32 token
#: rows and their mask). 64 MiB keeps caps up to 1,008 B (the main path's
#: 32, 128 and 512 among them) at full chunks of encode_pad_batch strings,
#: and gives longer strings smaller chunks
_ENCODE_CHUNK_BYTES = 1 << 26
#: most rows one launch of the multiget decode kernel takes, as encode caps
#: its strings: a larger multiget goes up in chunks of this many
_DECODE_MAX_ROWS = 1 << 16


def pack_strings(strings, pad_len: int | None = None,
                 pad_extra: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """list[bytes] (or an object array of bytes) -> (data uint8[B, L +
    pad_extra] zero padded, lens int32[B]).

    One join of the strings and one scatter of every byte to its row and
    column: no loop per string.
    """
    B = len(strings)
    lens = np.fromiter(map(len, strings), dtype=np.int64, count=B)
    L = pad_len if pad_len is not None else (int(lens.max()) if B else 1)
    too_long = np.flatnonzero(lens > L)
    if too_long.size:
        i = int(too_long[0])
        raise ValueError(f"string {i} has {lens[i]} bytes > pad_len={L}")
    width = L + pad_extra
    data = np.zeros((B, width), dtype=np.uint8)
    flat = np.frombuffer(b"".join(strings), dtype=np.uint8)
    if flat.size:
        # byte k of the join goes to k + (row start - string start)
        shift = np.arange(B, dtype=np.int64) * width - (np.cumsum(lens) - lens)
        data.reshape(-1)[np.arange(flat.size) + np.repeat(shift, lens)] = flat
    return data, lens.astype(np.int32)


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

    ``dictionary`` is a :class:`PackedDictionary` (uploaded here), a
    :class:`DeviceDict` already on ``device``, or a saved
    :class:`DictArtifact` (see :meth:`from_artifact`), which it keeps as
    ``artifact``.

    One instance may serve several stores (the shards of a sharded store
    share one upload of the tables), each under its own store lock: the
    state it changes after construction, the encode length caps and the
    lazy ``blob``, changes under the instance's own lock, and the caps list
    is replaced, never changed in place.
    """

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        #: the saved artifact the tables came from, where one was given: a
        #: store opened on this codec saves it as it is
        self.artifact = dictionary if isinstance(dictionary, DictArtifact) else None
        if isinstance(dictionary, DictArtifact):
            if not registry.capabilities(dictionary.codec).device_decodable:
                raise ValueError(
                    f"codec {dictionary.codec!r} is not device-decodable "
                    "(registry capability); run it on its host codec, "
                    "repro_torch.core.registry.codec_from_artifact(artifact), "
                    "as Encoder, Decoder and the stores do for it")
            dictionary = PackedDictionary.from_artifact(dictionary)
        #: the host dictionary, where one was given (None for bare tables)
        self.dictionary: PackedDictionary | None = None
        if isinstance(dictionary, DeviceDict):
            if dictionary.device.type != self.device.type:
                raise ValueError(f"dictionary tables are on {dictionary.device}, "
                                 f"not {self.device}")
            self.dd = dictionary
        else:
            if not dictionary.variant16:
                raise ValueError(
                    "device kernels target OnPair16 (<=16B entries); an "
                    "unbounded dictionary runs on the host: freeze it as an "
                    "'onpair' artifact and open its codec with "
                    "repro_torch.core.registry.codec_from_artifact")
            self.dictionary = dictionary
            self.dd = DeviceDict.build(dictionary, self.device)
        self._path = "cuda" if self.device.type == "cuda" else "ref"
        self._lock = threading.Lock()  # guards encode_len_caps and _blob
        #: the entry lengths on the host, which size a decode's output
        #: before its launch
        self.host_lens = self.dd.lens.cpu().numpy().astype(np.int64)
        self._blob: np.ndarray | None = None  # see blob
        #: the entry lengths as uint8 (OnPair16's are at most 16) for the
        #: stream kernel: 64 KiB, which its gathers find in L1
        self.lens8 = self.dd.lens.to(torch.uint8)
        # every launch uses a (<= encode_pad_batch, cap + 16) shape with cap
        # drawn from encode_len_caps, as in the reference's bucketed encode
        self.encode_len_caps: list[int] = list(_ENCODE_LEN_BUCKETS)
        self.encode_pad_batch: int = _ENCODE_PAD_BATCH

    @classmethod
    def from_artifact(cls, artifact: DictArtifact,
                      device: str | torch.device = "cuda") -> "OnPairDevice":
        """Open the device codec straight from a saved DictArtifact (the
        shipping path: train on one host, save, decode on another). Only
        ``"onpair16"`` artifacts with entries of at most 16 bytes run on the
        kernels; any other raises ValueError."""
        return cls(artifact, device)

    @property
    def resident_bytes(self) -> int:
        """The dictionary's in-memory footprint as the reference counts it
        (``PackedDictionary.resident_bytes``). Over bare device tables it is
        the same quantity computed from them: the tables hold the same
        arrays, and the entry bytes and 4-byte offsets that the host
        dictionary adds follow from ``lens``."""
        if self.dictionary is not None:
            return self.dictionary.resident_bytes
        return (self.dd.nbytes + int(self.dd.lens.sum())
                + 4 * (self.dd.num_entries + 1))

    @property
    def blob(self) -> np.ndarray:
        """The dictionary's entries back to back in id order (u8, on the
        host), the reference's ``PackedDictionary.blob``: the host
        dictionary's own, or built once from bare device tables."""
        with self._lock:
            if self._blob is None:
                d = self.dictionary
                self._blob = (np.asarray(d.blob, dtype=np.uint8) if d is not None
                              else np.frombuffer(b"".join(self.dd.entries()),
                                                 dtype=np.uint8))
            return self._blob

    # ----------------------------------------------------------- encode
    def _encode_cap(self, n: int) -> int:
        """Smallest bucket capacity >= n bytes, growing the set by doubling
        (a new list under the lock, so a reader sees the old set or the new
        one, whole)."""
        for cap in self.encode_len_caps:
            if n <= cap:
                return cap
        with self._lock:
            caps = list(self.encode_len_caps)
            while caps[-1] < n:
                caps.append(2 * caps[-1])
            self.encode_len_caps = caps
        return next(cap for cap in caps if n <= cap)

    def _encode_chunk(self, strings, cap: int) -> tuple[np.ndarray, np.ndarray]:
        """One launch at (len(strings), cap + 16) with ``max_tokens = cap``:
        (the strings' tokens back to back, int32; their counts, int32)."""
        data, lens = pack_strings(strings, pad_len=cap)
        toks, n = onpair_encode.encode_batch(
            torch.from_numpy(data).to(self.device),
            torch.from_numpy(lens).to(self.device), self.dd, cap)
        flat = toks[torch.arange(cap, device=toks.device) < n[:, None]]
        return flat.cpu().numpy(), n.cpu().numpy()

    def encode_flat(self, strings: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """Batch encode in a bounded set of shapes; returns (tokens int32,
        every string's stream back to back in input order; counts int64[B]).

        Strings are grouped into geometric byte-length buckets, and each
        group goes up in chunks of at most ``encode_pad_batch`` strings and
        ``_ENCODE_CHUNK_BYTES`` padded bytes, one launch each at (chunk,
        cap + 16) with ``max_tokens = cap`` (one token per byte is the worst
        case).
        """
        B = len(strings)
        counts = np.zeros(B, dtype=np.int64)
        if B == 0:
            return np.zeros(0, dtype=np.int32), counts
        lens = np.fromiter(map(len, strings), dtype=np.int64, count=B)
        np.maximum(lens, 1, out=lens)
        self._encode_cap(int(lens.max()))  # grows the caps to cover every string
        caps = np.asarray(self.encode_len_caps, dtype=np.int64)
        cap_of = caps[np.searchsorted(caps, lens, side="left")]
        objs = np.empty(B, dtype=object)  # gathers a chunk's strings in C
        objs[:] = strings
        chunks = []
        for cap in np.unique(cap_of):
            members = np.flatnonzero(cap_of == cap)
            pb = max(1, min(self.encode_pad_batch,
                            _ENCODE_CHUNK_BYTES // (int(cap) + 16)))
            for k in range(0, members.size, pb):
                sel = members[k : k + pb]
                flat, n = self._encode_chunk(objs[sel], int(cap))
                counts[sel] = n
                chunks.append((sel, flat, n.astype(np.int64)))
        starts = np.cumsum(counts) - counts
        tokens = np.empty(int(counts.sum()), dtype=np.int32)
        for sel, flat, n in chunks:
            # token k of the chunk moves by (string's start - its chunk start)
            shift = starts[sel] - (np.cumsum(n) - n)
            tokens[np.arange(flat.size) + np.repeat(shift, n)] = flat
        return tokens, counts

    def warm_encode(self) -> None:
        """Build or load the kernel library now (on CUDA), so the first
        encode pays no ``nvcc``. The CPU has nothing to build."""
        if self.device.type == "cuda":
            _build.load()

    def encode_to_bytes(self, strings: list[bytes]) -> list[bytes]:
        """Each string's compressed payload (its tokens as little-endian
        u16), in input order."""
        tokens, counts = self.encode_flat(strings)
        payload = tokens.astype("<u2").tobytes()
        bounds = np.concatenate(([0], np.cumsum(2 * counts))).tolist()
        return [payload[bounds[k] : bounds[k + 1]] for k in range(len(strings))]

    # ----------------------------------------------------------- decode
    def decode_stream(self, tokens: np.ndarray) -> bytes:
        """Decode one token stream (any concatenation of compressed strings)
        in one call of the stream kernel."""
        return self.decode_run(tokens, [np.asarray(tokens).size])[0]

    def upload_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """Host token ids on this device, after checking that they lie in
        the dictionary: uint16 as they are (2 B a token, the payload's own
        layout), any other integer type as int32."""
        tokens = np.asarray(tokens)
        if tokens.dtype != np.uint16:
            tokens = tokens.astype(np.int32)
        if tokens.size and (int(tokens.min()) < 0
                            or int(tokens.max()) >= self.dd.num_entries):
            raise ValueError(f"token ids must lie in [0, {self.dd.num_entries})")
        if not tokens.flags.writeable:  # torch takes only writable arrays
            tokens = tokens.copy()
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device)

    def decode_run(self, tokens: np.ndarray, counts) -> list[bytes]:
        """Decode the token streams of consecutive strings, concatenated in
        host ``tokens`` (string k holds ``counts[k]`` tokens), in one call
        of the stream kernel, and split the bytes per string.

        For callers that do not know the strings' decoded lengths: the
        tokens go up as they are (uint16 stays uint16), and the cumsum of
        their lengths, which gives the exact output size and the string
        boundaries, runs on the device; only the boundaries come back before
        the launch.
        """
        counts = np.asarray(counts, dtype=np.int64)
        tok = self.upload_tokens(tokens)
        if not tok.numel():
            return [b""] * counts.size
        byte_cum = torch.zeros(tok.numel() + 1, dtype=torch.int64, device=self.device)
        torch.cumsum(self.dd.lens[token_ids(tok)], 0, dtype=torch.int64,
                     out=byte_cum[1:])
        at = np.concatenate(([0], np.cumsum(counts)))
        bounds = byte_cum[torch.from_numpy(at).to(self.device)].cpu().numpy()
        return self.decode_span(tok[: int(at[-1])], np.diff(bounds))

    def decode_span(self, tokens: torch.Tensor, raw_lens) -> list[bytes]:
        """Decode consecutive strings whose tokens lie back to back in
        ``tokens`` (uint16 or int32, on this device, ids already checked:
        the store's mirror checks its tokens when it takes them) and whose
        decoded lengths ``raw_lens`` the host knows, in one call of the
        stream kernel, and split the bytes per string.

        The output's size and the string boundaries are one numpy cumsum, so
        nothing is read from the device before the launch. The kernel's
        ``out_len`` comes down with the bytes, on CUDA into pinned host
        memory that torch's host allocator keeps for the next call; a total
        that disagrees with ``raw_lens`` raises ValueError.
        """
        raw_lens = np.asarray(raw_lens, dtype=np.int64)
        bounds = np.zeros(raw_lens.size + 1, dtype=np.int64)
        np.cumsum(raw_lens, out=bounds[1:])
        size = int(bounds[-1])
        if not tokens.numel() and not size:
            return [b""] * raw_lens.size
        out, out_len = onpair_decode.decode_tokens(
            tokens, tokens.numel(), self.dd.mat16, self.lens8, size)
        if out.is_cuda:
            total = torch.empty(1, dtype=torch.int64, pin_memory=True)
            total.copy_(out_len.view(1), non_blocking=True)
            host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(out.device).synchronize()  # both copies landed
            out, out_len = host, total
        if int(out_len) != size:
            raise ValueError(f"the tokens decode to {int(out_len)} bytes, the "
                             f"strings' lengths add up to {size}")
        decoded = out.numpy().tobytes()
        b = bounds.tolist()
        return [decoded[lo:hi] for lo, hi in zip(b, b[1:])]

    def multiget_decode(self, token_lists: list[np.ndarray]) -> list[bytes]:
        """Random-access decode of ragged token streams, one string each, in
        one launch of the multiget decode kernel (per ``_DECODE_MAX_ROWS``
        strings): the tokens go up back to back, unpadded, with their
        starts."""
        counts = np.fromiter(map(len, token_lists), dtype=np.int64,
                             count=len(token_lists))
        if not counts.size:
            return []
        tokens = np.concatenate(token_lists).astype(np.int32)
        if tokens.size and (tokens.min() < 0 or tokens.max() >= self.dd.num_entries):
            raise ValueError(f"token ids must lie in [0, {self.dd.num_entries})")
        starts = np.zeros(counts.size + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        byte_cum = np.zeros(tokens.size + 1, dtype=np.int64)
        np.cumsum(self.host_lens[tokens], out=byte_cum[1:])
        return self._decode_rows(torch.from_numpy(tokens).to(self.device),
                                 np.diff(byte_cum[starts]), starts)

    def decode_ids(self, tokens: torch.Tensor, starts: torch.Tensor,
                   ids: np.ndarray, raw_lens: np.ndarray) -> list[bytes]:
        """Random-access decode of strings ``ids`` of a token buffer already
        on the device (``tokens`` uint16, string i at ``[starts[i],
        starts[i + 1])``), whose decoded lengths ``raw_lens`` the host
        knows: only the ids and the output offsets go up, in one copy, and
        only the decoded bytes come down."""
        return self._decode_rows(tokens, np.asarray(raw_lens, dtype=np.int64),
                                 np.asarray(ids, dtype=np.int64), starts)

    def _decode_rows(self, tokens: torch.Tensor, raw_lens: np.ndarray,
                     index: np.ndarray, starts: torch.Tensor | None = None
                     ) -> list[bytes]:
        """One launch of the rows kernel per ``_DECODE_MAX_ROWS`` rows.
        ``index`` holds the rows' string ids into the device ``starts``, or,
        with ``starts`` None, the rows' own token starts (one more entry than
        rows). Each launch uploads that and its output offsets (the cumsum of
        ``raw_lens``) as one int64 buffer, and copies exactly its output bytes
        down into pinned memory, which torch's host allocator keeps for the
        next call."""
        M = raw_lens.size
        out: list[bytes] = []
        for r0 in range(0, M, _DECODE_MAX_ROWS):
            m = min(M - r0, _DECODE_MAX_ROWS)
            off = np.zeros(m + 1, dtype=np.int64)
            np.cumsum(raw_lens[r0 : r0 + m], out=off[1:])
            head = index[r0 : r0 + m + (starts is None)]
            up = torch.from_numpy(np.concatenate((head, off))).to(self.device)
            ids, rows_starts = (up[:m], starts) if starts is not None else (None, up[: m + 1])
            size = int(off[-1])
            _DECODE_BATCHES[self._path].inc()
            with TRACER.span("kernel.decode_batch", path=self._path, rows=m,
                             bytes=size):
                data, _ = onpair_decode.decode_rows(
                    tokens, rows_starts, up[head.size :], size, self.dd.mat16,
                    self.dd.lens, ids=ids)
                if data.is_cuda:
                    data = torch.empty(size, dtype=torch.uint8,
                                       pin_memory=True).copy_(data)
                decoded = data.numpy().tobytes()
            b = off.tolist()
            out.extend([decoded[b[k] : b[k + 1]] for k in range(m)])
        return out
