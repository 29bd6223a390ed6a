"""Architecture registry: one module per assigned architecture (exact
published configs), the port's own copy of ``repro.configs``."""

from repro_torch.configs import (gemma2_2b, h2o_danube_1p8b,
                                 jamba_1p5_large, llama32_vision_90b,
                                 mamba2_780m, mixtral_8x22b, qwen1p5_4b,
                                 qwen3_moe_30b_a3b, whisper_medium, yi_9b)
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (yi_9b, h2o_danube_1p8b, gemma2_2b, qwen1p5_4b, whisper_medium,
              llama32_vision_90b, qwen3_moe_30b_a3b, mixtral_8x22b,
              jamba_1p5_large, mamba2_780m)
}


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells minus documented long_500k skips (DESIGN §5)."""
    cells = []
    for name, cfg in REGISTRY.items():
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.supports_long_decode:
                continue
            cells.append((name, sname))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for name, cfg in REGISTRY.items():
        if not cfg.supports_long_decode:
            out.append((name, "long_500k",
                        "pure full-attention: unbounded per-token cost"))
    return out
