"""granite-20b [dense] — llama-arch, code model, MQA (kv=1).

Assignment: 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324].

kv=1 (multi-query): the single KV head is REPLICATED across the 16-way
model axis; only Q heads shard (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab_size=49_152,
    head_dim=128,
    attn_bias=True,
)
