"""yi-9b [dense]: llama-arch GQA. 48L d_model=4096 32H (kv=4) d_ff=11008
vocab=64000 [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000, rope_theta=5_000_000.0,
)
