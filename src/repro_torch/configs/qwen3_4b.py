"""qwen3-4b [dense] — GQA with qk_norm.

Assignment: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm [hf:Qwen/Qwen3-8B].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
