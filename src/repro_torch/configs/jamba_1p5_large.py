"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave (1 attn per
8-layer block), MoE 16 experts top-2 on every 2nd layer. 72L d_model=8192
64H (kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf]. Mamba layers use
the SSD formulation (state=16, expand=2, head_dim=64)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_every=2,
    attn_period=8, ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    rope_theta=10_000.0,
)
