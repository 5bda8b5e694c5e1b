"""command-r-35b [dense] — GQA, no-bias.

Assignment: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    head_dim=128,
    attn_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)
