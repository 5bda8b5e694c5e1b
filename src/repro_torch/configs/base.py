"""Architecture configuration dataclasses (the port's own copy of
``repro/configs/base.py``, which is framework-free).

Every assigned architecture gets one ``ArchConfig`` describing the
transformer/SSM backbone exactly as assigned (see per-arch files).  The
same dataclass also describes the reduced smoke variants used by CPU
tests (``reduced()``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2) dims."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0          # per-expert hidden size
    shared_d_ff: int = 0          # shared-expert hidden size (total)
    first_dense_layers: int = 0   # leading layers that use a dense FFN
    dense_d_ff: int = 0           # hidden size of those dense layers
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128              # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_channels(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    source: str                   # citation from the assignment table
    num_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention details
    attn_type: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 => full attention in normal shapes
    long_context_window: int = 4096   # window used for long_500k on dense archs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared attention+MLP block applied every k layers
    shared_attn_every: int = 0
    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0
    # modality stubs
    n_prefix_tokens: int = 0      # image/audio embedding tokens prepended
    frontend_dim: int = 0         # raw embedding dim from the stub frontend
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- sharding-facing, derived at registry time ---
    vocab_pad_multiple: int = 16

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """All archs support long_500k: SSM/hybrid natively, attention archs
        via the sliding-window variant (DESIGN.md §4)."""
        return True

    def padded_heads(self, axis: int) -> Tuple[int, int]:
        """(q_heads, kv_heads) padded so the model axis divides q-heads and
        kv-heads are either sharded exactly or replicated."""
        q = pad_to_multiple(self.n_heads, axis) if self.n_heads else 0
        kv = self.n_kv_heads
        if kv and kv >= axis:
            kv = pad_to_multiple(kv, axis)
        elif kv:
            # replicated kv heads: pad to a divisor-friendly power of two
            kv = 1 << (kv - 1).bit_length()
        return q, kv

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count of the backbone (embeddings included)."""
        d = self.d_model
        n = 0
        n += self.padded_vocab * d                       # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d                   # lm head
        layers = self.num_layers if not self.is_encdec else (
            self.enc_layers + self.dec_layers)

        def attn_params() -> int:
            if self.attn_type == "mla":
                m = self.mla
                qdim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                p = d * qdim                                       # q proj
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)     # kv down
                p += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)             # kv up
                p += self.n_heads * m.v_head_dim * d               # o proj
                return p
            hq = self.n_heads * self.head_dim
            hkv = self.n_kv_heads * self.head_dim
            return d * hq + 2 * d * hkv + hq * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff                            # SwiGLU

        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            per = (d * (2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d))
                   + s.conv_channels(d) * s.conv_width
                   + di * d + 3 * s.n_heads(d) + di)
            n += layers * per
        elif self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            per = (d * (2 * di + 2 * s.n_groups * s.d_state + s.n_heads(d))
                   + s.conv_channels(d) * s.conv_width
                   + di * d + 3 * s.n_heads(d) + di)
            n += layers * per
            # one SHARED attention+MLP block (parameters reused)
            n += attn_params() + mlp_params(self.d_ff)
        else:
            per = attn_params()
            if self.moe and self.moe.n_routed_experts:
                m = self.moe
                moe_layers = layers - m.first_dense_layers
                n += m.first_dense_layers * mlp_params(m.dense_d_ff or self.d_ff)
                n += moe_layers * (
                    m.n_routed_experts * mlp_params(m.expert_d_ff)
                    + (mlp_params(m.shared_d_ff) if m.n_shared_experts else 0)
                    + d * m.n_routed_experts)            # router
                n += layers * per
            else:
                n += layers * (per + mlp_params(self.d_ff))
        if self.n_prefix_tokens and self.frontend_dim:
            n += self.frontend_dim * d                   # projector
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not (self.moe and self.moe.n_routed_experts):
            return self.param_count()
        m = self.moe
        full = self.param_count()
        layers = self.num_layers - m.first_dense_layers
        unused = (m.n_routed_experts - m.top_k) * 3 * self.d_model * m.expert_d_ff
        return full - layers * unused

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        d = min(self.d_model, 256)
        hd = 32
        nh = max(2, min(4, self.n_heads or 2))
        nkv = max(1, min(2, self.n_kv_heads or 1))
        kw = {}
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed_experts=min(4, self.moe.n_routed_experts),
                top_k=min(2, self.moe.top_k), expert_d_ff=64,
                shared_d_ff=64 if self.moe.n_shared_experts else 0,
                first_dense_layers=min(1, self.moe.first_dense_layers),
                dense_d_ff=128 if self.moe.first_dense_layers else 0)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk=16)
        return dataclasses.replace(
            self, name=self.name + "-reduced",
            num_layers=min(2, self.num_layers),
            enc_layers=min(2, self.enc_layers),
            dec_layers=min(2, self.dec_layers),
            d_model=d, n_heads=nh if self.n_heads else 0,
            n_kv_heads=nkv if self.n_kv_heads else 0,
            head_dim=hd, d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=64,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every else 0,
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            **kw)

    def flops_per_token(self, seq_len: int, decode: bool = False) -> float:
        """Rough forward FLOPs/token: 2*active_params + attention term."""
        f = 2.0 * self.active_param_count()
        if self.n_heads:
            ctx = min(seq_len, self.sliding_window or seq_len)
            layers = self.num_layers if not self.is_encdec else self.dec_layers
            hd = (self.mla.v_head_dim if self.attn_type == "mla"
                  else self.head_dim)
            f += 2.0 * layers * self.n_heads * hd * (ctx if decode else ctx)
        return f


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ArchConfig):
    """The published Zamba2 hybrid (``models/zamba2.py``'s docstring has
    its equations): ``num_mem_blocks`` weight-shared attention+MLP blocks
    invoked in turn before the Mamba layers ``hybrid_layer_ids``.  Each
    invocation reads ``concat(x, x0)`` (width ``2 d_model``), attends
    with ``n_heads`` heads of ``head_dim`` at the scale ``(head_dim /
    2) ** -0.5``, runs a gated-GELU MLP of ``d_ff`` with its own
    rank-``adapter_rank`` adapter, and maps the result through its own
    ``d_model x d_model`` linear into the next Mamba layer's input.  The
    Mamba layers' gated norm runs over ``ssm.n_groups`` groups."""
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 0

    @property
    def attn_width(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def attn_scale(self) -> float:
        return (self.head_dim / 2) ** -0.5

    def _mamba_layer_params(self) -> int:
        s, d = self.ssm, self.d_model
        di, H = s.d_inner(d), s.n_heads(d)
        return (d * (2 * di + 2 * s.n_groups * s.d_state + H)    # in projs
                + s.conv_channels(d) * (s.conv_width + 1)        # convs, bias
                + 3 * H + di + di * d + d)       # A_log, D, dt_bias, norms

    def _shared_block_params(self) -> int:
        d, a = self.d_model, self.attn_width
        kv = self.n_kv_heads * self.head_dim
        return (2 * d + 2 * d * (a + 2 * kv) + a * d + d
                + 3 * d * self.d_ff)

    def _invocation_params(self) -> int:
        d = self.d_model
        return d * self.adapter_rank + self.adapter_rank * 2 * self.d_ff \
            + d * d

    def param_count(self) -> int:
        n = self.padded_vocab * self.d_model * (1 if self.tie_embeddings
                                                 else 2)
        return (n + self.d_model + self.num_layers * self._mamba_layer_params()
                + self.num_mem_blocks * self._shared_block_params()
                + len(self.hybrid_layer_ids) * self._invocation_params())

    def flops_per_token(self, seq_len: int, decode: bool = False) -> float:
        """Forward FLOPs a token: 2 per weight it touches (the shared
        blocks once per invocation, the tied head once) plus the score
        and value products over ``seq_len`` keys in every invocation."""
        J = len(self.hybrid_layer_ids)
        touched = (self.padded_vocab * self.d_model + self.d_model
                   + self.num_layers * self._mamba_layer_params()
                   + J * (self._shared_block_params()
                          + self._invocation_params()))
        return 2.0 * touched + 4.0 * J * self.attn_width * seq_len

    def reduced(self) -> "Zamba2Config":
        """Smoke-test variant: 3 layers with both blocks invoked (before
        layers 1 and 2), ``ArchConfig.reduced``'s widths, adapter rank 8."""
        r = super().reduced()
        return dataclasses.replace(
            r, num_layers=min(3, self.num_layers), hybrid_layer_ids=(1, 2),
            num_mem_blocks=min(2, self.num_mem_blocks),
            adapter_rank=min(8, self.adapter_rank))
