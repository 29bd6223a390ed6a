"""mamba2-780m [ssm]: attention-free SSD (state-space duality). 48L
d_model=1536 vocab=50280 ssm_state=128 [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
)
