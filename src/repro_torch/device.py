"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The default is the card. Without CUDA the caller must ask for the CPU
    explicitly (``device="cpu"``); the port never carries on silently on the
    host when a card was asked for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device='cuda' was requested (the default) but CUDA "
            "is not available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
