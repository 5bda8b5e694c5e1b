"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2.

Assignment: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064,
MoE 16e top-2 [hf:microsoft/Phi-3.5-MoE-instruct].
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    head_dim=128,
    moe=MoEConfig(n_routed_experts=16, n_shared_experts=0, top_k=2,
                  expert_d_ff=6400),
)
