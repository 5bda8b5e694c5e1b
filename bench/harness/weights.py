"""Member weights and the side models' fitting data, from the seed.

Weights are drawn on the device with one ``torch.Generator`` in one
call: a flat buffer of standard normals clipped at +-2, then one
multiply-add of a per-element scale and shift, and every leaf is a view
into it.  Conv and head weights are scaled by 1/sqrt(fan-in); conv and
head biases, GroupNorm scales (about 1) and shifts get 0.1-sized draws,
so that every parameter moves the served score."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.counts.convs import inner_width


def _leaves(m: Dict) -> List[Tuple[tuple, tuple, str, float]]:
    """``(path, shape, kind, fan_in)`` of every leaf of one member's
    params tree (the port's layout: conv weights ``[K, Cin//g, Cout]``)."""
    W, K, card = m["width"], m["kernel_size"], m["cardinality"]
    inner = inner_width(W, card)
    out = []

    def conv(path, k, cin, cout, groups=1):
        cg = cin // groups
        out.append((path + ("w",), (k, cg, cout), "w", k * cg))
        out.append((path + ("b",), (cout,), "b", 0))

    def gn(path, c):
        out.append((path + ("scale",), (c,), "scale", 0))
        out.append((path + ("bias",), (c,), "b", 0))

    conv(("stem",), K, 1, W)
    gn(("stem_gn",), W)
    for i in range(m["blocks"]):
        p = ("blocks", i)
        conv(p + ("reduce",), 1, W, inner)
        gn(p + ("gn1",), inner)
        conv(p + ("stripe",), K, inner, inner, card)
        gn(p + ("gn2",), inner)
        conv(p + ("expand",), 1, inner, W)
        gn(p + ("gn3",), W)
    out.append((("head", "w"), (W, 2), "w", W))
    out.append((("head", "b"), (2,), "b", 0))
    return out


def _tree(m: Dict) -> Dict:
    return {"stem": {}, "stem_gn": {},
            "blocks": [{k: {} for k in ("reduce", "gn1", "stripe", "gn2",
                                        "expand", "gn3")}
                       for _ in range(m["blocks"])],
            "head": {}}


def make_params(members: Sequence[Dict], seed: int,
                device: torch.device) -> List[Dict]:
    """One params tree a member, all views of one buffer on ``device``."""
    layout = [_leaves(m) for m in members]
    leaves = [leaf for lv in layout for leaf in lv]
    total = sum(int(np.prod(shape)) for _, shape, _, _ in leaves)
    scale = np.empty(total, np.float32)
    shift = np.zeros(total, np.float32)
    off = 0
    for _, shape, kind, fan in leaves:
        n = int(np.prod(shape))
        scale[off:off + n] = fan ** -0.5 if kind == "w" else 0.1
        if kind == "scale":
            shift[off:off + n] = 1.0
        off += n
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(off, generator=g, device=device).clamp_(-2.0, 2.0)
    flat.mul_(torch.from_numpy(scale).to(device)).add_(
        torch.from_numpy(shift).to(device))
    out, off = [], 0
    for m, lv in zip(members, layout):
        tree = _tree(m)
        for path, shape, _, _ in lv:
            n = int(np.prod(shape))
            node = tree
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = flat[off:off + n].view(shape)
            off += n
        out.append(tree)
    return out


def side_data(config: Dict, seed: int) -> Dict[str, np.ndarray]:
    """Seeded fitting data for the vitals forest and the labs regression:
    labels that depend on the late vitals and on a direction in the labs,
    so both models learn something."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 3])
    n = int(config["side_fit_rows"])
    W = int(round(config["vitals_hz"] * config["window_seconds"]))
    vit = rng.standard_normal((n, config["vitals_channels"], W))
    labs = rng.standard_normal((n, config["labs"]))
    v = rng.standard_normal(config["labs"])
    y_vit = (vit[:, :, -5:].mean(axis=(1, 2))
             + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    y_labs = (labs @ v + 0.5 * rng.standard_normal(n) > 0).astype(np.float64)
    return {"vitals": vit, "vitals_y": y_vit, "labs": labs,
            "labs_y": y_labs}
