"""internvl2-26b [vlm] — InternViT + InternLM2 language backbone.

Assignment: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821].  vocab padded to 92560.

Per assignment carve-out: the InternViT-6B vision encoder + projector
frontend is a STUB — ``input_specs()`` supplies precomputed patch
embeddings (batch, n_image_tokens, frontend_dim); the backbone projects
them to d_model and interleaves with text tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    head_dim=128,
    n_prefix_tokens=1024,             # ViT patch tokens per image
    frontend_dim=3200,                # InternViT-6B width
)
