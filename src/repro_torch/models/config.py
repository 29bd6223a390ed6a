"""Architecture configuration schema covering all 10 assigned families.

One frozen dataclass describes every architecture; family-specific switches
(SWA, local/global alternation, softcaps, MoE, SSD, cross-attention,
encoder-decoder) compose rather than fork the model code. Block periodicity
(`layers_per_block`) drives the scan-over-blocks structure that keeps HLO
size and compile time bounded at 100+ layers.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None     # default d_model // n_heads

    # attention flavour
    qkv_bias: bool = False                      # qwen1.5
    sliding_window: int | None = None           # SWA (danube, mixtral)
    local_global_period: int = 0                # gemma2: 2 -> alternate local/global
    attn_logit_softcap: float | None = None     # gemma2
    final_logit_softcap: float | None = None    # gemma2
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # jamba: MoE on every 2nd layer
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_period: int = 0             # jamba: 1 attention layer per this many

    # encoder-decoder / multimodal
    enc_layers: int = 0              # whisper encoder depth
    enc_seq: int = 0                 # whisper: 1500 frames (stub frontend)
    cross_attn_period: int = 0       # llama-vision: 1 cross-attn block per 5
    n_vision_tokens: int = 0         # vlm stub: precomputed patch embeddings

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # --- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def layers_per_block(self) -> int:
        """Heterogeneous layer period: the scan unit."""
        if self.family == "hybrid" and self.attn_period:
            return self.attn_period
        if self.family == "vlm" and self.cross_attn_period:
            return self.cross_attn_period
        if self.local_global_period:
            return self.local_global_period
        if self.n_experts and self.moe_every > 1:
            return self.moe_every
        return 1

    @property
    def n_blocks(self) -> int:
        lpb = self.layers_per_block
        assert self.n_layers % lpb == 0, (self.name, self.n_layers, lpb)
        return self.n_layers // lpb

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """long_500k runnability: bounded per-token cost (SSM state or SWA).

        Pure full-attention archs are skipped per spec (DESIGN.md §5).
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.sliding_window is not None and not self.local_global_period:
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive side

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.hd, self.n_heads, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params() -> int:
            p = D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D
            if self.qkv_bias:
                p += (H + 2 * K) * hd
            return p + 2 * D                     # norms

        def mlp_params() -> int:
            return 3 * D * F + D                 # swiglu + norm

        def moe_params() -> int:
            return self.n_experts * 3 * D * F + D * self.n_experts + D

        def ssm_params() -> int:
            inner = self.ssm_expand * D
            nh = inner // self.ssm_head_dim
            # in_proj -> (z, x, B, C, dt), out_proj, conv, A/D/dt_bias, norm
            p = D * (2 * inner + 2 * self.ssm_state + nh)
            p += inner * D + self.ssm_conv * (inner + 2 * self.ssm_state)
            p += 3 * nh + 2 * D
            return p

        for layer in range(self.n_layers):
            if self.family == "ssm":
                total += ssm_params()
                continue
            if self.family == "hybrid":
                is_attn = (layer % self.attn_period) == (self.attn_period - 1)
                total += attn_params() if is_attn else ssm_params()
                if self.n_experts and (layer % self.moe_every == self.moe_every - 1):
                    total += moe_params()
                else:
                    total += mlp_params()
                continue
            total += attn_params()
            if self.n_experts and (layer % self.moe_every == self.moe_every - 1):
                total += moe_params()
            else:
                total += mlp_params()
        if self.family == "vlm" and self.cross_attn_period:
            # cross-attn blocks add one attention per block
            total += (self.n_layers // self.cross_attn_period) * attn_params()
        if self.enc_layers:
            total += self.enc_layers * (attn_params() + mlp_params())
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        full = self.n_params()
        moe_layers = sum(1 for k in range(self.n_layers)
                         if k % self.moe_every == self.moe_every - 1)
        per_expert = 3 * self.d_model * self.d_ff
        inactive = moe_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=max(2, self.layers_per_block) if self.layers_per_block > 1
            else 2,
            d_model=64, n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads)),
            d_ff=128, vocab_size=512, head_dim=16,
        )
        if self.n_experts:
            changes["n_experts"] = max(4, self.top_k)
            changes["top_k"] = min(2, self.top_k)
        if self.family in ("ssm", "hybrid"):
            changes["ssm_state"] = 16
            changes["ssm_head_dim"] = 16
        if self.enc_layers:
            changes["enc_layers"] = 2
            changes["enc_seq"] = 16
        if self.n_vision_tokens:
            changes["n_vision_tokens"] = 8
        if self.sliding_window:
            changes["sliding_window"] = 8
        if self.family == "hybrid" and self.attn_period:
            changes["n_layers"] = self.attn_period
        if self.family == "vlm" and self.cross_attn_period:
            changes["n_layers"] = self.cross_attn_period
        if self.local_global_period:
            changes["n_layers"] = 2 * self.local_global_period
        return replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
