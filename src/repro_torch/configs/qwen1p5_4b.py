"""qwen1.5-4b [dense]: MHA (kv=20) with QKV bias. 40L d_model=2560 20H
d_ff=6912 vocab=151936 [hf:Qwen/Qwen1.5-0.5B scaled per assignment; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936, qkv_bias=True, rope_theta=1_000_000.0,
)
