"""smollm-360m [dense] — llama-arch small.

Assignment: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M].

15 q-heads / 5 kv-heads do not divide a 16-way model axis: q heads are
padded 15->16 and kv 5->8; padding heads are zero-init (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    head_dim=64,
    tie_embeddings=True,
)
