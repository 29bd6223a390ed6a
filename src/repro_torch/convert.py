"""Carry a trained dictionary and an encoded corpus across from the JAX
reference's state into the port, as plain numpy arrays.

The caller reads the arrays off the reference's objects (this module never
imports them): the fields of its ``PackedDictionary`` named in
:data:`repro_torch.kernels.ref.ARRAY_FIELDS` plus its probe bounds, and its
``CompressedCorpus`` payload and offsets. A store the reference trained and
encoded can then be served by the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import CompressedCorpus
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import DeviceDict


def dictionary_from_reference(arrays: dict[str, np.ndarray], s_probe_max: int,
                              p_probe_max: int, max_bucket: int,
                              device: str | torch.device = "cuda") -> DeviceDict:
    """The port's device tables from a reference PackedDictionary's arrays
    (``mat16``, ``lens``, ``s_*``, ``p_*``, ``bucket_start``/``bucket_size``,
    ``suf_*``) and probe bounds (``max_bucket`` is the reference's
    ``max(1, max_bucket_size)``)."""
    return DeviceDict.from_arrays(arrays, s_probe_max=s_probe_max,
                                  p_probe_max=p_probe_max, max_bucket=max_bucket,
                                  device=resolve_device(device))


def corpus_from_reference(payload: np.ndarray, offsets: np.ndarray,
                          raw_bytes: int) -> CompressedCorpus:
    """The port's corpus from a reference corpus's payload (u8, u16 token
    ids little-endian) and per-string byte offsets."""
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or offsets.size < 1 or offsets[0] != 0 \
            or offsets[-1] != payload.size or np.any(np.diff(offsets) < 0) \
            or np.any(offsets % 2):
        raise ValueError("offsets must rise from 0 to the payload size in "
                         "whole 2-byte tokens")
    return CompressedCorpus(payload=payload, offsets=offsets,
                            raw_bytes=int(raw_bytes),
                            meta={"compressor": "onpair16"})
