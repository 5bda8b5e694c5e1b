"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

Assignment: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64 [arXiv:2411.15242].

81 Mamba2 layers; ONE parameter-shared attention+MLP block is invoked every
6 layers (Zamba's shared-block trick) — its params are reused each time.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=112,                     # 3584 / 32
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=128),
    shared_attn_every=6,
    sliding_window=0,
    tie_embeddings=True,
)
