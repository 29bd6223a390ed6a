"""llama-3.2-vision-90b [vlm]: 100L = 20 blocks of [1 gated cross-attn +
4 self-attn]; vision frontend is a STUB — input_specs() provides precomputed
(B, 1601, d_model) patch embeddings. d_model=8192 64H (kv=8) d_ff=28672
vocab=128256 [hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    cross_attn_period=5, n_vision_tokens=1601, rope_theta=500_000.0,
)
