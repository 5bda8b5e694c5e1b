"""Plain forward pass of the published Zamba2 (Zamba2-7B-Instruct,
https://huggingface.co/Zyphra/Zamba2-7B-Instruct; arXiv:2411.15242), one
session at a time, teacher-forced.

With ``x0 = embed(tokens)`` and ``x = x0``, for layer l:

* l the j-th of ``hybrid_layer_ids`` (block b = j mod blocks)::

      h = RMSNorm_b(concat(x, x0))
      q, k, v = h Wq_b, h Wk_b, h Wv_b          # heads of head_dim
      q, k = RoPE(q), RoPE(k)                   # half rotation, all dims
      a = softmax_causal(q k^T (head_dim / 2)^-1/2) v Wo_b
      m = RMSNorm'_b(a)
      g, u = split(m Wgu_b + (m A_j) B_j)
      t = ((GELU(g) * u) Wdown_b) L_j
      x = x + Mamba_l(RMSNorm_l(x + t))

* otherwise ``x = x + Mamba_l(RMSNorm_l(x))``,

``Mamba_l``: z, x, B, C, dt projections; a causal depthwise conv of the
config's width with bias, then SiLU, over x, B and C; the SSD scan with
``A = -exp(A_log)``, ``dt = softplus(dt + dt_bias)`` and the D skip, in
chunks of ``chunk_size`` steps (the configuration's 256); ``y =
RMSNormGated(y * SiLU(z))`` over ``mamba_ngroups`` groups; out_proj.
Logits ``RMSNorm(x) E^T``, tied.  GELU is exact (erf).

Float32 with both TF32 flags off; attention materialised over the
session's whole sequence.  ``tf32=True`` rounds every operand of every
matrix product and contraction to TF32 (10 mantissa bits, nearest even)
and sums in float32: the control of the benchmark's check.  The weights
are a nested dict in the layout ``bench/harness/zamba2_runner.py`` draws;
nothing here imports the port, so later changes to the program cannot
move the yardstick."""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence

import torch
import torch.nn.functional as F

from bench.reference.resnext import round_tf32


@contextlib.contextmanager
def fp32() -> Iterator[None]:
    """Both TF32 flags off for the block, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Zamba2:
    """The forward of one configuration (a ``bench/configs`` file's
    keys) over one set of weights."""

    def __init__(self, config: Dict, params: Dict, tf32: bool = False):
        self.c = config
        self.p = params
        self.tf32 = tf32
        self.eps = float(config["rms_norm_eps"])

    # ------------------------------------------------------------ maths
    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self.tf32 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def ein(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self._r(x) for x in xs])

    def norm(self, x: torch.Tensor, scale: torch.Tensor,
             groups: int = 1) -> torch.Tensor:
        xg = x.unflatten(-1, (groups, -1))
        xg = xg * torch.rsqrt(xg.square().mean(-1, keepdim=True) + self.eps)
        return xg.flatten(-2) * scale

    @staticmethod
    def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
        """x ``[T, heads, dim]`` at positions 0 .. T-1, half rotation."""
        half = x.shape[-1] // 2
        freqs = torch.exp(-math.log(theta) * torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(x.shape[0], dtype=torch.float32,
                           device=x.device)[:, None, None] * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    # ----------------------------------------------------------- blocks
    def shared(self, j: int, x: torch.Tensor,
               x0: torch.Tensor) -> torch.Tensor:
        c = self.c
        b = j % int(c["num_mem_blocks"])
        blk = {k: _index(v, b) for k, v in self.p["shared"].items()}
        inv = {k: v[j] for k, v in self.p["invocations"].items()}
        T = x.shape[0]
        H, hd = int(c["num_attention_heads"]), int(c["attention_head_dim"])
        Hkv = int(c["num_key_value_heads"])
        h = self.norm(torch.cat([x, x0], -1), blk["ln1"]["scale"])
        q = self.mm(h, blk["attn"]["wq"]["w"]).view(T, H, hd)
        k = self.mm(h, blk["attn"]["wk"]["w"]).view(T, Hkv, hd)
        v = self.mm(h, blk["attn"]["wv"]["w"]).view(T, Hkv, hd)
        theta = float(c["rope_theta"])
        q, k = self.rope(q, theta), self.rope(k, theta)
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
        s = self.ein("shd,thd->hst", q, k) * (hd / 2) ** -0.5
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        a = self.ein("hst,thd->shd", torch.softmax(s, -1), v)
        del s
        a = self.mm(a.reshape(T, H * hd), blk["attn"]["wo"]["w"])
        m = self.norm(a, blk["ln2"]["scale"])
        gu = self.mm(m, blk["mlp"]["gate_up"]["w"]) \
            + self.mm(self.mm(m, inv["adapter_a"]), inv["adapter_b"])
        g, u = gu.chunk(2, -1)
        t = self.mm(F.gelu(g) * u, blk["mlp"]["down"]["w"])
        return self.mm(t, inv["linear"])

    def conv(self, x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv: x ``[T, ch]``, taps w ``[K, 1, ch]``
        (oldest first), bias ``[ch]``; then SiLU."""
        K = w.shape[0]
        xp = F.pad(x, (0, 0, K - 1, 0))
        T = x.shape[0]
        y = sum(self._r(xp[i:i + T]) * self._r(w[i, 0]) for i in range(K))
        return F.silu(y + b)

    def scan(self, x, dt, A, Bm, Cm, D) -> torch.Tensor:
        """SSD over chunks of ``chunk_size``: x ``[T, H, P]``, dt ``[T,
        H]``, A ``[H]``, B and C ``[T, G, N]``, D ``[H]`` -> y ``[T, H,
        P]``, from a zero state."""
        T, H, P = x.shape
        rep = H // Bm.shape[1]
        Bh, Ch = Bm.repeat_interleave(rep, 1), Cm.repeat_interleave(rep, 1)
        h = x.new_zeros(H, P, Bm.shape[2])
        L = int(self.c["chunk_size"])
        ys = []
        for c0 in range(0, T, L):
            sl = slice(c0, min(T, c0 + L))
            n = sl.stop - sl.start
            cs = torch.cumsum(dt[sl] * A, 0)                     # [n, H]
            seg = cs[:, None, :] - cs[None, :, :]                # [i, j, H]
            low = torch.ones(n, n, dtype=torch.bool,
                             device=x.device).tril()[..., None]
            decay = torch.exp(seg.masked_fill(~low, float("-inf")))
            cb = self.ein("ihn,jhn->ijh", Ch[sl], Bh[sl])
            y = self.ein("ijh,jhp->ihp", cb * decay * dt[sl][None], x[sl])
            y = y + self.ein("ihn,hpn->ihp", Ch[sl], h) \
                * torch.exp(cs)[..., None]
            last = torch.exp(cs[-1][None] - cs) * dt[sl]          # [n, H]
            h = h * torch.exp(cs[-1])[:, None, None] + self.ein(
                "jh,jhp,jhn->hpn", last, x[sl], Bh[sl])
            ys.append(y + x[sl] * D[None, :, None])
        return torch.cat(ys)

    def mamba(self, l: int, u: torch.Tensor) -> torch.Tensor:
        c = self.c
        p = {k: _index(v, l) for k, v in self.p["mamba"]["mixer"].items()}
        G, N = int(c["mamba_ngroups"]), int(c["mamba_d_state"])
        P = int(c["mamba_headdim"])
        T = u.shape[0]
        z = self.mm(u, p["z_proj"])
        xs = self.conv(self.mm(u, p["x_proj"]), p["conv_x"], p["conv_bx"])
        Bm = self.conv(self.mm(u, p["B_proj"]), p["conv_B"], p["conv_bB"])
        Cm = self.conv(self.mm(u, p["C_proj"]), p["conv_C"], p["conv_bC"])
        dt = F.softplus(self.mm(u, p["dt_proj"]) + p["dt_bias"])
        y = self.scan(xs.view(T, -1, P), dt, -torch.exp(p["A_log"]),
                      Bm.view(T, G, N), Cm.view(T, G, N), p["D"])
        y = self.norm(y.reshape(T, -1) * F.silu(z), p["norm"]["scale"], G)
        return self.mm(y, p["out_proj"])

    # ---------------------------------------------------------- forward
    def layer(self, l: int, x: torch.Tensor, x0: torch.Tensor,
              j) -> torch.Tensor:
        """Layer l; ``j`` the invocation before it, or None."""
        h = x if j is None else x + self.shared(j, x, x0)
        return x + self.mamba(l, self.norm(h,
                                           self.p["mamba"]["ln"]["scale"][l]))

    def logits(self, tokens: torch.Tensor,
               at: Sequence[int]) -> torch.Tensor:
        """Teacher-forced logits ``[len(at), V]`` of one session's
        ``tokens`` ``[T]`` at positions ``at``."""
        ids = [int(i) for i in self.c["hybrid_layer_ids"]]
        with fp32():
            x0 = self.p["embed"]["table"][tokens.long()]
            x = x0
            for l in range(int(self.c["num_hidden_layers"])):
                x = self.layer(l, x, x0, ids.index(l) if l in ids else None)
            at = torch.as_tensor(list(at), device=x.device)
            xf = self.norm(x[at], self.p["final_norm"]["scale"])
            return self.mm(xf, self.p["embed"]["table"].T)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
