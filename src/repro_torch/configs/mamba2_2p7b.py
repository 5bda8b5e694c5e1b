"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.

Assignment: 64L d_model=2560 (attn-free) vocab=50280, ssm_state=128
[arXiv:2405.21060].  vocab padded to 50288 for 16-way sharding.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    attn_type="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=128),
    tie_embeddings=True,
)
