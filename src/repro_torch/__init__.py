"""repro_torch — the OnPair16 serving path on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

A second package beside the JAX reference ``repro``: it trains an OnPair16
dictionary, encodes a corpus through the encode kernel and serves store
multigets through the decode kernel. It imports ``torch``, ``numpy`` and the
standard library only — never ``jax`` and never a module of ``repro``; the
pieces it shares with the reference are its own copies under the same
relative paths.

Entry points take ``device=`` and default to ``"cuda"``; see
:func:`repro_torch.device.resolve_device`.
"""
