"""gemma2-2b [dense]: alternating local(4k SWA)/global attention, logit
softcaps, tied embeddings, 256k vocab. 26L d_model=2304 8H (kv=4) d_ff=9216
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    local_global_period=2, sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True, rope_theta=10_000.0,
)
