"""The published Zamba2 (``Zamba2Config``, ``zamba2-7b-instruct``; HF
``Zamba2ForCausalLM``), beside the reference's simplified hybrid in
``hybrid.py`` (``zamba2-7b``), with which it shares no layer code.
With ``x0 = embed(tokens)`` and ``x = x0``, for layer l = 0 .. L-1:

* if l is the j-th entry of ``hybrid_layer_ids`` (block b = j mod
  ``num_mem_blocks``)::

      h = RMSNorm_b(concat(x, x0))                    # width 2 d
      q, k, v = h Wq_b, h Wk_b, h Wv_b                # heads of head_dim
      q, k = RoPE(q), RoPE(k)                         # all of head_dim
      a = softmax_causal(q k^T (head_dim / 2)^-1/2) v Wo_b   # -> d
      m = RMSNorm'_b(a)
      g, u = split(m Wgu_b + (m A_j) B_j)             # adapter j
      t = ((GELU(g) * u) Wdown_b) L_j                 # linear j
      x = x + Mamba_l(RMSNorm_l(x + t))

  (no residual inside the block: ``t`` reaches the residual stream only
  through the Mamba layer's input);
* otherwise ``x = x + Mamba_l(RMSNorm_l(x))``;

``Mamba_l`` as ``ssm.mamba2_apply`` with its gated norm over
``ssm.n_groups`` groups; logits ``RMSNorm(x) E^T`` (tied).  GELU is the
exact-erf one.  Params: ``{"embed", "final_norm", "mamba": {"ln",
"mixer"} stacked [L, ...], "shared": {"ln1", "attn", "ln2", "mlp":
{"gate_up", "down"}} stacked [num_mem_blocks, ...], "invocations":
{"adapter_a", "adapter_b", "linear"} stacked [J, ...]}`` (``layout``).
Cache: ``{"mamba": [L, ...], "attn": {"k", "v"} of [J, B, M, nkv,
head_dim], "pos": [M], "position": [1] int32, "idx": int}``: ``position``
is the next position on the cache's device, ``idx`` its host mirror;
on the card a decode step adds ``"graphs"``, its CUDA graphs.  Every
norm scale, conv bias, ``A_log``, ``D`` and ``dt_bias`` is drawn, so
none sits at a constant that would hide its absence.  ``prefill(...,
cache=, rows=)`` writes a group of sessions into batch rows of a cache
that ``init_cache`` preallocated; a decode step and each part of it are
spans (``obs/spans.py``: ``lm.mamba``, ``lm.shared`` with ``.attn`` and
``.mlp``, ``lm.head``), and it counts ``kv_positions``.  On the card
the step replays one CUDA graph a leaf span (``_StepGraphs``) from its
second step on a cache; elsewhere it issues every op from Python.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Zamba2Config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed, rms_norm,
                                       truncated_normal_init, unembed)
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.models.transformer import (_layer, _stack, cache_len,
                                            fit_kv_cache)
from repro_torch.obs.spans import count, span


def layout(cfg: Zamba2Config, kv_mult: int = 1
           ) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """``(path, shape, kind)`` of every leaf of the published params tree,
    stacked axes first (``L``, ``num_mem_blocks`` or ``J``, under
    ``mamba``, ``shared`` and ``invocations``).  ``kind``: ``"w"`` a
    weight and ``"conv"`` a conv's taps (fan-in: the first axis after
    the stacked one), ``"table"`` the tied embedding, ``"norm"`` a norm's
    scale, ``"bias"`` a conv bias, ``"A_log"``, ``"D"``,
    ``"dt_bias"``."""
    s, d = cfg.ssm, cfg.d_model
    di, H, gn, K = (s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state,
                    s.conv_width)
    L, nb, J = cfg.num_layers, cfg.num_mem_blocks, len(cfg.hybrid_layer_ids)
    a, r, ff = cfg.attn_width, cfg.adapter_rank, cfg.d_ff
    kv = cfg.n_kv_heads * kv_mult * cfg.head_dim
    mx = ("mamba", "mixer")
    out = [(("embed", "table"), (cfg.padded_vocab, d), "table"),
           (("final_norm", "scale"), (d,), "norm"),
           (("mamba", "ln", "scale"), (L, d), "norm")]
    out += [(mx + (n,), (L,) + shape, kind) for n, shape, kind in (
        ("z_proj", (d, di), "w"), ("x_proj", (d, di), "w"),
        ("B_proj", (d, gn), "w"), ("C_proj", (d, gn), "w"),
        ("dt_proj", (d, H), "w"),
        ("conv_x", (K, 1, di), "conv"), ("conv_B", (K, 1, gn), "conv"),
        ("conv_C", (K, 1, gn), "conv"),
        ("conv_bx", (di,), "bias"), ("conv_bB", (gn,), "bias"),
        ("conv_bC", (gn,), "bias"),
        ("A_log", (H,), "A_log"), ("D", (H,), "D"),
        ("dt_bias", (H,), "dt_bias"),
        ("out_proj", (di, d), "w"))]
    out.append((mx + ("norm", "scale"), (L, di), "norm"))
    out += [(("shared",) + path, (nb,) + shape, kind) for path, shape, kind
            in ((("ln1", "scale"), (2 * d,), "norm"),
                (("attn", "wq", "w"), (2 * d, a), "w"),
                (("attn", "wk", "w"), (2 * d, kv), "w"),
                (("attn", "wv", "w"), (2 * d, kv), "w"),
                (("attn", "wo", "w"), (a, d), "w"),
                (("ln2", "scale"), (d,), "norm"),
                (("mlp", "gate_up", "w"), (d, 2 * ff), "w"),
                (("mlp", "down", "w"), (ff, d), "w"))]
    out += [(("invocations", n), (J,) + shape, "w") for n, shape in (
        ("adapter_a", (d, r)), ("adapter_b", (r, 2 * ff)),
        ("linear", (d, d)))]
    return out


def _draw(gen, shape, kind: str, lead: Sequence[int], dtype, device):
    """One leaf of ``kind`` (``layout``): weights truncated normal over
    the fan-in; norm scales ``1 + 0.1 n``; conv biases ``0.1 n``;
    ``A_log = log U(1, 16)``; ``D = 1 + 0.1 n``; ``dt_bias`` the inverse
    softplus of ``dt = exp U(log 1e-3, log 1e-1)`` (Mamba2's init)."""
    if kind in ("w", "table", "conv"):
        return truncated_normal_init(gen, shape, 1.0, dtype, device, lead)
    full = tuple(lead) + tuple(shape)
    f32 = torch.float32
    if kind in ("A_log", "dt_bias"):
        u = torch.rand(full, generator=gen, dtype=f32, device=device)
        if kind == "A_log":
            return torch.log(1.0 + 15.0 * u)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3)).clamp_(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    n = torch.randn(full, generator=gen, dtype=f32, device=device)
    n.clamp_(-2.0, 2.0).mul_(0.1)
    if kind in ("norm", "D"):
        n.add_(1.0)
    return n if kind == "D" else n.to(dtype)


def _set(tree: dict, path: Sequence[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def init(gen: torch.Generator, cfg: Zamba2Config, rt: RuntimeOptions,
         device: DeviceLike = None):
    """Random params in the layout ``layout`` gives, drawn from ``gen``
    on ``device`` (``cuda:0`` unless the caller names another)."""
    device = resolve_device(device)
    params: dict = {}
    for path, shape, kind in layout(cfg, rt.kv_mult):
        lead = shape[:1] if path[0] in ("mamba", "shared",
                                        "invocations") else ()
        _set(params, path, _draw(gen, shape[len(lead):], kind, lead,
                                 rt.dtype, device))
    return params


def init_cache(cfg: Zamba2Config, rt: RuntimeOptions, batch: int,
               seq_len: int, device: DeviceLike = None):
    """Empty decode cache sized for ``seq_len`` total positions."""
    device = resolve_device(device)
    M = cache_len(cfg, rt, seq_len)
    shape = (len(cfg.hybrid_layer_ids), batch, M,
             cfg.n_kv_heads * rt.kv_mult, cfg.head_dim)
    return {"mamba": ssm_mod.ssm_cache_init(cfg, batch, rt.dtype, device,
                                            (cfg.num_layers,)),
            "attn": {"k": torch.zeros(shape, dtype=rt.dtype, device=device),
                     "v": torch.zeros(shape, dtype=rt.dtype, device=device)},
            "pos": torch.full((M,), -1, dtype=torch.int32, device=device),
            "position": torch.zeros((1,), dtype=torch.int32, device=device),
            "idx": 0}


def _embed(params, tokens, rt):
    return embed(params["embed"], tokens.long()).to(rt.dtype)


def _segments(cfg: Zamba2Config) -> List[Tuple[int, int, Optional[int]]]:
    """``(lo, hi, j)`` of each stretch of the layers: invocation ``j`` of
    a shared block (None before the first), then the Mamba layers ``lo
    .. hi - 1`` (none when ``hi == lo``)."""
    b = [0] + list(cfg.hybrid_layer_ids) + [cfg.num_layers]
    return [(b[s], b[s + 1], s - 1 if s else None) for s in range(len(b) - 1)]


def _shared_attn(cfg: Zamba2Config, rt, blk, x, x0, positions, ring=None,
                 cache_pos=None, cache_idx=None):
    """The first half of a shared block's invocation: its attention over
    ``concat(x, x0)`` and ``wo`` -> ``(a, K/V)``; given ``ring`` (decode),
    slot ``cache_idx % M`` of the ring and ``cache_pos`` are written in
    place (``attention.gqa_apply``)."""
    h = rms_norm(torch.cat([x, x0], dim=-1), blk["ln1"], cfg.norm_eps)
    return attn.gqa_apply(
        blk["attn"], h, positions, cfg, cache=ring, cache_pos=cache_pos,
        cache_idx=cache_idx, window=rt.eff_window(cfg), causal=True,
        kv_mult=rt.kv_mult, impl=rt.impl, chunk=rt.attn_chunk,
        scale=cfg.attn_scale)


def _shared_mlp(cfg: Zamba2Config, blk, inv, a):
    """The second half: ``t``, the next Mamba layer's extra input."""
    m = rms_norm(a, blk["ln2"], cfg.norm_eps)
    gu = m @ blk["mlp"]["gate_up"]["w"] + \
        (m @ inv["adapter_a"]) @ inv["adapter_b"]
    g, u = gu.chunk(2, dim=-1)
    return (F.gelu(g) * u) @ blk["mlp"]["down"]["w"] @ inv["linear"]


def _invoke(cfg: Zamba2Config, rt, blk, inv, x, x0, positions):
    """One invocation of a shared block over a sequence: its ``t`` and
    the sequence's K/V, each half in its span."""
    with span("lm.shared"):
        with span("lm.shared.attn"):
            a, kv = _shared_attn(cfg, rt, blk, x, x0, positions)
        with span("lm.shared.mlp"):
            t = _shared_mlp(cfg, blk, inv, a)
    return t, kv


def _mamba(p, x, t, cfg: Zamba2Config, rt, cache=None,
           return_cache: bool = False):
    """One Mamba layer: ``x + Mamba(RMSNorm(x + t))`` (of ``x`` when ``t``
    is None) and the state ``ssm.mamba2_apply`` returns."""
    h = x if t is None else x + t
    y, new_c = ssm_mod.mamba2_apply(
        p["mixer"], rms_norm(h, p["ln"], cfg.norm_eps), cfg, cache=cache,
        return_cache=return_cache, impl=rt.impl,
        norm_groups=cfg.ssm.n_groups)
    return x + y, new_c


def _backbone(params, x, cfg: Zamba2Config, rt, mode, cache=None,
              rows=None):
    """The layers of the module's equations over a whole sequence.
    ``mode`` ``"train"``: the forward; ``"prefill"``: also the prompt's
    K/V and states, written into batch ``rows`` of ``cache`` when it is
    given, else returned as (K/V by invocation, Mamba states by layer).
    Returns (x, kvs, states).  A decode step is ``_Step``'s."""
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    pre = mode == "prefill"
    into = pre and cache is not None
    x0, kvs, states = x, [], []
    for lo, hi, j in _segments(cfg):
        t = None
        if j is not None:
            t, kv = _invoke(cfg, rt,
                            _layer(params["shared"], j % cfg.num_mem_blocks),
                            _layer(params["invocations"], j), x, x0,
                            positions)
            if into:
                for name in ("k", "v"):
                    cache["attn"][name][j, rows, :S].copy_(kv[name])
            elif pre:
                kvs.append(kv)
            del kv
        if hi == lo:
            continue
        with span("lm.mamba"):
            for l in range(lo, hi):
                x, new_c = _mamba(_layer(params["mamba"], l), x,
                                  t if l == lo else None, cfg, rt,
                                  return_cache=pre)
                if into:
                    for name, v in new_c.items():
                        cache["mamba"][name][l, rows].copy_(v)
                elif pre:
                    states.append(new_c)
    return x, kvs, states


def forward(params, tokens: torch.Tensor, cfg: Zamba2Config,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None):
    """Teacher-forced logits ``[B, S, V_padded]`` and a zero aux term."""
    x = _backbone(params, _embed(params, tokens, rt), cfg, rt, "train")[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x), torch.zeros((), device=x.device)


def prefill(params, tokens: torch.Tensor, cfg: Zamba2Config,
            rt: RuntimeOptions, prefix_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, cache: Optional[dict] = None,
            rows: Optional[slice] = None):
    """Returns (last-token logits ``[B, V_padded]``, decode cache);
    ``max_len`` sizes the rings (defaults to S + 128).  Given ``cache``
    (``init_cache``'s, every session at the same position), the prompt's
    K/V and states go into its batch ``rows`` instead, in place, and
    that cache is returned: its rings, states and position buffer keep
    their tensors, so a decode step's graphs stay valid."""
    B, S = tokens.shape
    if cache is not None:
        rows = slice(0, B) if rows is None else rows
        M = cache["attn"]["k"].shape[2]
        if S > M:
            raise ValueError(f"prefill of {S} positions into a ring of {M}")
    x, kvs, states = _backbone(params, _embed(params, tokens, rt), cfg, rt,
                               "prefill", cache, rows)
    with span("lm.head"):
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = unembed(params["embed"], x)[:, 0]
    if cache is not None:
        pos = torch.arange(cache["pos"].shape[0], dtype=torch.int32,
                           device=cache["pos"].device)
        cache["pos"].copy_(torch.where(pos < S, pos, -1))
        cache["position"].fill_(S)
        cache["idx"] = S
        return logits, cache
    M = cache_len(cfg, rt, max_len or S + 128)
    kv, pos = fit_kv_cache(_stack(kvs), S, M)
    return logits, {"mamba": _stack(states), "attn": kv, "pos": pos,
                    "position": torch.full((1,), S, dtype=torch.int32,
                                           device=pos.device),
                    "idx": S}


class _Step:
    """One decode step over ``cache`` as pieces, each a function of the
    step's state ``st`` that advances the cache in place: the tokens in
    (``"tok"``), ``"x"``, ``"x0"``, ``"a"`` and ``"t"`` between pieces,
    the logits out (``"logits"``).  A piece is a run of Mamba layers,
    either half of a shared block's invocation, or the head (which also
    advances the cache's ``position``); the first piece also embeds.
    The attention reads its positions and ring slot from ``position`` on
    the device, so no piece reads a host value that changes from step to
    step: a CUDA graph of each replays it (``_StepGraphs``)."""

    def __init__(self, params, cache, cfg: Zamba2Config, rt):
        at = cache["position"]
        nb = cfg.num_mem_blocks
        self.plan: List[Tuple[str, int]] = []      # (span, first piece)
        self.pieces: List[Callable[[dict], None]] = []

        def mamba_run(lo, hi):
            ps = [_layer(params["mamba"], l) for l in range(lo, hi)]
            cs = [_layer(cache["mamba"], l) for l in range(lo, hi)]

            def run(st):
                x, t = st["x"], st.pop("t", None)
                for p, c in zip(ps, cs):
                    x, _ = _mamba(p, x, t, cfg, rt, cache=c)
                    t = None
                st["x"] = x
            return run

        def attn_half(j):
            blk, ring = _layer(params["shared"], j % nb), \
                _layer(cache["attn"], j)

            def run(st):
                st["a"] = _shared_attn(cfg, rt, blk, st["x"], st["x0"], at,
                                       ring, cache["pos"], at)[0]
            return run

        def mlp_half(j):
            blk = _layer(params["shared"], j % nb)
            inv = _layer(params["invocations"], j)

            def run(st):
                st["t"] = _shared_mlp(cfg, blk, inv, st.pop("a"))
            return run

        def head(st):
            x = rms_norm(st.pop("x"), params["final_norm"], cfg.norm_eps)
            st["logits"] = unembed(params["embed"], x)[:, 0]
            at.add_(1)

        for lo, hi, j in _segments(cfg):
            if j is not None:
                self.plan.append(("lm.shared", len(self.pieces)))
                self.pieces += [attn_half(j), mlp_half(j)]
            if hi > lo:
                self.plan.append(("lm.mamba", len(self.pieces)))
                self.pieces.append(mamba_run(lo, hi))
        self.plan.append(("lm.head", len(self.pieces)))
        self.pieces.append(head)
        first = self.pieces[0]

        def embedded(st):
            st["x"] = st["x0"] = _embed(params, st["tok"][:, None], rt)
            first(st)
        self.pieces[0] = embedded

    def walk(self, run: Callable[[int], None], kv_positions: int) -> None:
        """``run(k)`` for every piece k in order, each in its span (one
        ``lm.shared`` an invocation, over ``.attn`` and ``.mlp``);
        ``kv_positions`` counted for each invocation."""
        for name, k in self.plan:
            if name == "lm.shared":
                with span("lm.shared"):
                    with span("lm.shared.attn"):
                        run(k)
                    with span("lm.shared.mlp"):
                        run(k + 1)
                count("kv_positions", kv_positions)
            else:
                with span(name):
                    run(k)

    def eager(self, token: torch.Tensor, kv_positions: int) -> torch.Tensor:
        """The step with every op issued from Python; its logits."""
        st = {"tok": token}
        self.walk(lambda k: self.pieces[k](st), kv_positions)
        return st["logits"]


def _leaves(cache) -> Tuple[torch.Tensor, ...]:
    return (*cache["mamba"].values(), cache["attn"]["k"], cache["attn"]["v"],
            cache["pos"], cache["position"])


class _StepGraphs:
    """The decode step of one params tree over one cache's tensors as
    CUDA graphs, one a piece of ``_Step``, each replayed inside its span.
    The first step runs eagerly on the graphs' own stream (it warms the
    kernels' plans and cuBLAS there); the second captures every piece
    on that stream, into one memory pool (a piece's outputs are the next
    one's inputs, and the graphs replay in the order they were
    captured), then replays them, as does every later step.  Each replay
    adds its graph's kernel launches to the kernels' counters
    (``_build.CaptureLaunches``); a replayed step counts its graphs in
    ``graph_replays``.  The graphs are kept with the cache and hold for
    its tensors and ``params`` only (``fits``)."""

    def __init__(self, params, cache, cfg: Zamba2Config, rt):
        self.params = params
        self.leaves = _leaves(cache)
        self.step = _Step(params, cache, cfg, rt)
        self.stream = torch.cuda.Stream(cache["position"].device)
        self.warm = False
        self.graphs: Optional[List[tuple]] = None     # (graph, launches)
        self.st: Optional[dict] = None                # the static tensors

    def fits(self, params, cache) -> bool:
        return self.params is params and all(
            a is b for a, b in zip(self.leaves, _leaves(cache)))

    def __call__(self, token: torch.Tensor, kv_positions: int
                 ) -> torch.Tensor:
        """One step of ``token`` ``[B]``: its logits, a tensor of their
        own.  The graphs' stream waits for the caller's, and the caller's
        then waits for it."""
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            if not self.warm:
                logits = self.step.eager(token, kv_positions)
                self.warm = True
            else:
                if self.graphs is None:
                    self._capture(token)
                self.st["tok"].copy_(token)
                self.step.walk(self._replay, kv_positions)
                count("graph_replays", len(self.graphs))
                logits = self.st["logits"].clone()
        caller.wait_stream(self.stream)
        return logits

    def _capture(self, token: torch.Tensor) -> None:
        st = {"tok": token.clone()}
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        with _build.CAPTURE_LOCK:
            for piece in self.step.pieces:
                graph = torch.cuda.CUDAGraph()
                with _build.CaptureLaunches() as launches:
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        piece(st)
                    finally:
                        graph.capture_end()
                graphs.append((graph, launches))
        self.st, self.graphs = st, graphs

    def _replay(self, k: int) -> None:
        graph, launches = self.graphs[k]
        graph.replay()
        for counter, n in launches.items():
            counter.add(n)


def _eager_step(params, cache, token: torch.Tensor, cfg: Zamba2Config,
                rt: RuntimeOptions):
    """``decode_step`` with every op issued from Python: its path off the
    card, and what its graphs are held to on the card."""
    logits = _Step(params, cache, cfg, rt).eager(token,
                                                 _kv_positions(cache, token))
    cache["idx"] += 1
    return logits, cache


def _kv_positions(cache, token: torch.Tensor) -> int:
    """K/V positions a step's attention reads in one invocation, summed
    over the sessions (the host's count, from ``idx``)."""
    return token.shape[0] * min(cache["idx"] + 1, cache["pos"].shape[0])


def decode_step(params, cache, token: torch.Tensor, cfg: Zamba2Config,
                rt: RuntimeOptions):
    """token: ``[B]`` int.  Returns (logits ``[B, V_padded]``, the cache
    advanced in place, with ``idx + 1``).  Where the kernels run (a
    cache on the card), the step replays CUDA graphs kept in the cache
    (``_StepGraphs``, made anew for another ``params``); elsewhere it
    issues its ops from Python (``_eager_step``).  ``idx`` stays the
    host's mirror of ``position``."""
    at = cache["position"]
    if not (at.is_cuda and ops.resolve(rt.impl, at) == "cuda"):
        return _eager_step(params, cache, token, cfg, rt)
    graphs = cache.get("graphs")
    if graphs is None or not graphs.fits(params, cache):
        graphs = cache["graphs"] = _StepGraphs(params, cache, cfg, rt)
    logits = graphs(token, _kv_positions(cache, token))
    cache["idx"] += 1
    return logits, cache
