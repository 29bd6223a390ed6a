"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, every layer MoE. 48L
d_model=2048 32H (kv=4) expert d_ff=768 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, rope_theta=1_000_000.0,
)
