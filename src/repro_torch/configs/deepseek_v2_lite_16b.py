"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed (top-6) + 2 shared.

Assignment: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512 [arXiv:2405.04434].

Note (DESIGN.md §4): the assignment line also mentions "160 routed" which is
DeepSeek-V2-*full*'s expert count; we follow the primary spec (64 routed,
top-6, 2 shared).  First layer uses a dense FFN (model card: 10944), routed
expert hidden = 1408, shared expert hidden = 2×1408.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,                    # MLA: kv heads == q heads post up-proj
    d_ff=1408,
    vocab_size=102_400,
    head_dim=192,                     # qk_nope(128)+qk_rope(64)
    attn_type="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed_experts=64, n_shared_experts=2, top_k=6,
                  expert_d_ff=1408, shared_d_ff=2816,
                  first_dense_layers=1, dense_d_ff=10_944),
    rope_theta=10_000.0,
)
