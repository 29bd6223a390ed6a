"""repro_torch — the OnPair16 serving path on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``), and the paper's other codecs
on the host.

A second package beside the JAX reference ``repro``: it trains an OnPair16
dictionary, encodes a corpus through the encode kernel, serves store
multigets through the decode kernel and scans through the stream kernel,
appends and compacts in the writable store, answers reverse lookups
(``locate``, ``scan_prefix``) and saves and opens stores in the reference's
files (``DictArtifact``, ``CompressedCorpus.save``, the store directories),
so either package opens what the other wrote. The codec registry
(:mod:`repro_torch.core.registry`) holds every codec of the paper's Table 3
(OnPair, OnPair16, BPE, FSST, the block codecs, raw); the ones with no
kernel run on the host, as in the reference, and the stores serve the
token-stream ones (OnPair, BPE) there. It imports ``torch``, ``numpy`` and
the standard library only (and ``zstandard`` where it is installed) — never
``jax`` and never a module of ``repro``; the pieces it shares with the
reference are its own copies under the same relative paths.

Entry points of OnPair16 take ``device=`` and default to ``"cuda"``; see
:func:`repro_torch.device.resolve_device`.
"""
