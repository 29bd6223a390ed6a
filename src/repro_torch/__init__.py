"""repro_torch — the OnPair16 serving path on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

A second package beside the JAX reference ``repro``: it trains an OnPair16
dictionary, encodes a corpus through the encode kernel, serves store
multigets through the decode kernel and scans through the stream kernel,
appends and compacts in the writable store, answers reverse lookups
(``locate``, ``scan_prefix``) and saves and opens stores in the reference's
files (``DictArtifact``, ``CompressedCorpus.save``, the store directories),
so either package opens what the other wrote. It imports ``torch``, ``numpy`` and the
standard library only — never ``jax`` and never a module of ``repro``; the
pieces it shares with the reference are its own copies under the same
relative paths.

Entry points take ``device=`` and default to ``"cuda"``; see
:func:`repro_torch.device.resolve_device`.
"""
