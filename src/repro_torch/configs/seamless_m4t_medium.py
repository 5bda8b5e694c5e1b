"""seamless-m4t-medium [audio] — encoder-decoder backbone.

Assignment: 12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206,
enc-dec multimodal [arXiv:2308.11596].

Per assignment carve-out: the mel-spectrogram + conv feature extractor
frontend is a STUB — ``input_specs()`` supplies precomputed audio frame
embeddings of shape (batch, n_frames, frontend_dim); we implement the
encoder-decoder transformer that consumes them.  12L is interpreted as
12 encoder + 12 decoder layers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596",
    num_layers=24,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,               # padded to 256208 for 16-way sharding
    head_dim=64,
    n_prefix_tokens=1024,             # audio frames fed to the encoder
    frontend_dim=1024,
)
