"""Carry state across from the JAX reference into the port, as plain numpy
arrays: a trained dictionary, an encoded corpus, and an LM's parameter,
cache and train-state trees.

The caller reads the arrays off the reference's objects (this module never
imports them): the fields of its ``PackedDictionary`` named in
:data:`repro_torch.kernels.ref.ARRAY_FIELDS` plus its probe bounds, its
``CompressedCorpus`` payload and offsets, and the leaves of its parameter or
cache tree (``jax.tree_util.tree_map(np.asarray, tree)``). A store the
reference trained and encoded can then be served by the port, and a model
it initialised run by the port's.
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


def _leaf_from_reference(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16 as its bit pattern: numpy has no bf16 of its own
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if a.dtype not in (np.float32, np.int32, np.int8):
        raise ValueError(f"unexpected leaf dtype {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def _tree_from_reference(tree, device) -> dict:
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf_from_reference(node, dev)

    return walk(tree)


def params_from_reference(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The port's parameter tree from a reference parameter tree whose leaves
    are numpy arrays: the same keys, shapes and dtypes (the leading block
    axis of ``blocks`` / ``enc_blocks`` included).

    bf16 leaves arrive as ``uint16`` bit views (``np.asarray(x).view(
    np.uint16)``, the layout of the reference's checkpoints) or as numpy
    arrays of ``ml_dtypes``' bfloat16, and become ``torch.bfloat16`` with the
    same bits. float32 and int32 leaves (an fp32 config's tree; the router,
    ``A_log``, ``D``, ``dt_bias`` and ``xgate`` of any config) keep their
    dtype. An fp32 upcast of a bf16 tree is taken as fp32: cast the result
    back with ``.to(torch.bfloat16)`` if that is wanted.
    """
    return _tree_from_reference(tree, device)


def cache_from_reference(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The port's decode cache from a reference cache (``init_cache`` or
    ``prefill``'s): ``{"blocks": ..., "pos": int32 scalar}`` with the same
    keys, shapes and dtypes; bf16 leaves as in
    :func:`params_from_reference`."""
    return _tree_from_reference(tree, device)


def state_from_reference(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The port's train state from a reference train state (``{"params",
    "opt": {"m", "v", "count"}, "step"}``): parameters as in
    :func:`params_from_reference`, both moments in fp32 or as q8 blocks
    (``{"q": int8, "scale": fp32}``), and the int32 ``count`` and
    ``step``, with the same keys, shapes and dtypes."""
    return _tree_from_reference(tree, device)
