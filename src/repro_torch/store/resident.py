"""The sealed segments of a store, mirrored on its device.

The multiget decode kernel reads strings from here, so a multiget ships
only ids and output offsets: one growable u8 buffer holds every sealed
string's payload (little-endian u16 tokens) in global id order, beside an
int64 token start per string (one more than strings, so a string's token
count is the difference of two starts). The host keeps the same starts and
each string's decoded length, summed once from the dictionary's entry
lengths when the string is mirrored, so a multiget sizes its output and
its offsets with one numpy cumsum and launches without reading the device
first.

:meth:`ResidentSegments.append` checks and measures new strings on the
host and uploads their payload and starts at once, in one copy each;
buffers grow by doubling. The store appends under its lock: at build, at
every seal, and anew after ``compact()`` swaps the dictionary.

The cold tier takes a demoted segment's tokens off the device
(:meth:`ResidentSegments.evict`) and puts them back when it promotes the
segment (:meth:`ResidentSegments.restore`). An evicted string keeps an
empty token range, so global ids still index the starts directly and a
multiget of hot ids stays one launch; its decoded length stays known. Both
rebuild the payload buffer at its exact new size with one device copy of
the bytes kept, so the room an eviction frees goes back at once, and a
store whose every segment went cold and came back holds the same bytes as
one never tiered.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import OnPairDevice


def _reserve_tensor(t: torch.Tensor, used: int, need: int) -> torch.Tensor:
    """``t`` with room for ``need`` elements, its first ``used`` kept."""
    if need <= t.numel():
        return t
    grown = torch.empty(max(need, 2 * t.numel()), dtype=t.dtype, device=t.device)
    grown[:used].copy_(t[:used])
    return grown


def _reserve_array(a: np.ndarray, used: int, need: int) -> np.ndarray:
    if need <= a.size:
        return a
    grown = np.empty(max(need, 2 * a.size), dtype=a.dtype)
    grown[:used] = a[:used]
    return grown


class ResidentSegments:
    """Sealed strings' payload and token starts on ``device``'s card (or
    CPU), and their token starts and decoded lengths on the host."""

    def __init__(self, device: OnPairDevice):
        self._device = device
        dev = device.device
        self.n_strings = 0
        self.n_bytes = 0
        self._payload = torch.empty(0, dtype=torch.uint8, device=dev)
        self._starts = torch.zeros(1, dtype=torch.int64, device=dev)
        self._host_starts = np.zeros(1, dtype=np.int64)
        self._raw_lens = np.zeros(0, dtype=np.int64)
        #: evicted string ranges, lo -> hi
        self.evicted: dict[int, int] = {}

    @property
    def host_starts(self) -> np.ndarray:
        """int64 token start of each string and the end of the last."""
        return self._host_starts[: self.n_strings + 1]

    @property
    def raw_lens(self) -> np.ndarray:
        """Decoded byte length of each sealed string (int64, host)."""
        return self._raw_lens[: self.n_strings]

    @property
    def device_bytes(self) -> int:
        """Bytes the mirror holds on its device, spare room included."""
        return self._payload.nbytes + self._starts.nbytes

    def token_counts(self, ids: np.ndarray) -> np.ndarray:
        s = self._host_starts
        return s[ids + 1] - s[ids]

    def _measure(self, payload: np.ndarray, offsets: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(the strings' payload bytes as a writable copy, their local token
        offsets, their decoded lengths) of ``payload`` u8 with each string's
        byte range at ``offsets`` (k + 1 entries, even byte offsets, as a
        segment or corpus holds them); every token checked against the
        dictionary."""
        offsets = np.asarray(offsets, dtype=np.int64)
        o0, o1 = int(offsets[0]), int(offsets[-1])
        if (offsets % 2).any() or np.any(np.diff(offsets) < 0) or o1 > payload.size:
            raise ValueError("segment offsets must be even, ascending and "
                             "inside the payload")
        chunk = np.array(payload[o0:o1], dtype=np.uint8)  # writable, for torch
        tok = chunk.view("<u2")
        lens = self._device.host_lens
        if tok.size and int(tok.max()) >= lens.size:
            raise ValueError(f"sealed payload holds token {int(tok.max())}, past "
                             f"the dictionary's {lens.size} entries")
        local = (offsets - o0) // 2                       # local token offsets
        byte_cum = np.zeros(tok.size + 1, dtype=np.int64)
        np.cumsum(lens[tok], out=byte_cum[1:])
        return chunk, local, byte_cum[local[1:]] - byte_cum[local[:-1]]

    def append(self, payload: np.ndarray, offsets: np.ndarray) -> None:
        """Mirror sealed strings behind those already here (``payload`` and
        ``offsets`` as :meth:`_measure` takes them). Every token is checked
        against the dictionary before anything changes."""
        chunk, local, raw = self._measure(payload, offsets)
        k, n, nb = local.size - 1, self.n_strings, self.n_bytes
        self._host_starts = _reserve_array(self._host_starts, n + 1, n + 1 + k)
        self._host_starts[n + 1 : n + 1 + k] = local[1:] + nb // 2
        self._raw_lens = _reserve_array(self._raw_lens, n, n + k)
        self._raw_lens[n : n + k] = raw
        self._payload = _reserve_tensor(self._payload, nb, nb + chunk.size)
        self._payload[nb : nb + chunk.size].copy_(torch.from_numpy(chunk))
        self._starts = _reserve_tensor(self._starts, n + 1, n + 1 + k)
        self._starts[n + 1 : n + 1 + k].copy_(
            torch.from_numpy(self._host_starts[n + 1 : n + 1 + k]))
        self.n_bytes = nb + chunk.size
        self.n_strings = n + k

    def _check_range(self, lo: int, hi: int) -> None:
        if not 0 <= lo < hi <= self.n_strings:
            raise ValueError(f"string range [{lo}, {hi}) is not inside the "
                             f"mirror's [0, {self.n_strings})")

    def _rebuild(self, t0: int, cut: int, insert: torch.Tensor | None) -> None:
        """The payload anew at its exact size: tokens before ``t0``, then
        ``insert`` (when given), then the tokens from ``t0 + cut`` on."""
        a, b, nb = 2 * t0, 2 * (t0 + cut), self.n_bytes
        mid = 0 if insert is None else insert.numel()
        new = torch.empty(nb - (b - a) + mid, dtype=torch.uint8,
                          device=self._payload.device)
        new[:a].copy_(self._payload[:a])
        if insert is not None:
            new[a : a + mid].copy_(insert)
        new[a + mid :].copy_(self._payload[b:nb])
        self._payload = new
        self.n_bytes = new.numel()

    def evict(self, lo: int, hi: int) -> int:
        """Take the tokens of strings ``[lo, hi)`` off the device: the tokens
        behind them move down, and the later starts shift on the card and on
        the host. The strings keep empty ranges and their decoded lengths.
        Returns the payload bytes freed. Raises ValueError, changing
        nothing, when the range leaves the mirror or meets an evicted one."""
        self._check_range(lo, hi)
        if any(a < hi and lo < b for a, b in self.evicted.items()):
            raise ValueError(f"strings [{lo}, {hi}) are already evicted in part")
        s, n = self._host_starts, self.n_strings
        t0, t1 = int(s[lo]), int(s[hi])
        self._rebuild(t0, t1 - t0, None)
        s[lo + 1 : hi + 1] = t0
        s[hi + 1 : n + 1] -= t1 - t0
        self._starts[lo + 1 : hi + 1].fill_(t0)
        self._starts[hi + 1 : n + 1].sub_(t1 - t0)
        self.evicted[lo] = hi
        return 2 * (t1 - t0)

    def restore(self, lo: int, hi: int, payload: np.ndarray,
                offsets: np.ndarray) -> int:
        """Put back the evicted strings ``[lo, hi)`` from their payload and
        local offsets (a segment's), in id order: one upload of the payload
        and one of their starts; the later starts shift back. Returns the
        payload bytes restored. Raises ValueError, changing nothing, unless
        ``[lo, hi)`` is exactly one evicted range and the payload decodes to
        the strings' known lengths."""
        if self.evicted.get(lo) != hi:
            raise ValueError(f"strings [{lo}, {hi}) are not an evicted range")
        chunk, local, raw = self._measure(payload, offsets)
        if local.size - 1 != hi - lo or not np.array_equal(raw, self.raw_lens[lo:hi]):
            raise ValueError(f"the payload given for strings [{lo}, {hi}) does "
                             "not decode to their lengths")
        s, n = self._host_starts, self.n_strings
        t0, d = int(s[lo]), int(local[-1])
        self._rebuild(t0, 0, torch.from_numpy(chunk).to(self._payload.device))
        s[lo + 1 : hi + 1] = t0 + local[1:]
        s[hi + 1 : n + 1] += d
        self._starts[lo + 1 : hi + 1].copy_(torch.from_numpy(s[lo + 1 : hi + 1]))
        self._starts[hi + 1 : n + 1].add_(d)
        del self.evicted[lo]
        return chunk.size

    def on_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(every sealed string's tokens back to back, uint16; the int64
        token starts, ``n_strings + 1`` of them), both on the device."""
        return (self._payload[: self.n_bytes].view(torch.uint16),
                self._starts[: self.n_strings + 1])
