"""zamba2-7b-instruct [hybrid] — Zamba2-7B-Instruct at its published
config (https://huggingface.co/Zyphra/Zamba2-7B-Instruct, config.json;
arXiv:2411.15242).

81 Mamba2 layers (d_inner 7168, 112 heads of 64, 2 groups of state 64,
conv 4 with bias) and two weight-shared attention+MLP blocks invoked in
turn before the 13 Mamba layers ``hybrid_layer_ids``: each invocation
reads ``concat(x, x0)`` (7168 wide), attends with 32 heads of 224 (RoPE
over all 224, theta 10000, scale ``(224 / 2) ** -0.5``), runs a
gated-GELU MLP of 14336 with its own rank-128 adapter, and adds its own
3584 x 3584 linear's output to the next Mamba layer's input.  Tied
embedding.  The config's ``chunk_size`` is 256; ``ssm.chunk`` is the
``ssd`` kernel's 128-step tile (``kernels/ssd.py`` ``MAX_CHUNK``), a
blocking of the same recurrence.  ``zamba2-7b`` is the JAX package's
simplified version of the same model, kept for parity.
"""
from repro_torch.configs.base import SSMConfig, Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b-instruct",
    family="hybrid",
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
    num_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=224,                     # attention_hidden_size 7168 / 32
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  n_groups=2, chunk=128),
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
    norm_eps=1e-5,
    tie_embeddings=True,
)
