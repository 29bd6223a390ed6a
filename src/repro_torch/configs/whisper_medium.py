"""whisper-medium [audio]: encoder-decoder; conv frontend is a STUB —
input_specs() provides precomputed (B, 1500, d_model) frame embeddings.
24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865
[arXiv:2212.04356; unverified]. Positional encoding stubbed with RoPE
(DESIGN.md §Arch-applicability)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    enc_layers=24, enc_seq=1500, rope_theta=10_000.0,
)
