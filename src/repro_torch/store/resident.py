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

    def append(self, payload: np.ndarray, offsets: np.ndarray) -> None:
        """Mirror sealed strings behind those already here: ``payload`` u8
        with each string's byte range at ``offsets`` (k + 1 entries, even
        byte offsets, as a segment or corpus holds them). Every token is
        checked against the dictionary before anything changes."""
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
        k, n, nb = offsets.size - 1, self.n_strings, self.n_bytes
        self._host_starts = _reserve_array(self._host_starts, n + 1, n + 1 + k)
        self._host_starts[n + 1 : n + 1 + k] = local[1:] + nb // 2
        self._raw_lens = _reserve_array(self._raw_lens, n, n + k)
        self._raw_lens[n : n + k] = byte_cum[local[1:]] - byte_cum[local[:-1]]
        self._payload = _reserve_tensor(self._payload, nb, nb + chunk.size)
        self._payload[nb : nb + chunk.size].copy_(torch.from_numpy(chunk))
        self._starts = _reserve_tensor(self._starts, n + 1, n + 1 + k)
        self._starts[n + 1 : n + 1 + k].copy_(
            torch.from_numpy(self._host_starts[n + 1 : n + 1 + k]))
        self.n_bytes = nb + chunk.size
        self.n_strings = n + k

    def on_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(every sealed string's tokens back to back, uint16; the int64
        token starts, ``n_strings + 1`` of them), both on the device."""
        return (self._payload[: self.n_bytes].view(torch.uint16),
                self._starts[: self.n_strings + 1])
