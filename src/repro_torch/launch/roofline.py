"""Roofline analysis over the port's dry run (``repro/launch/roofline.py``).

Terms per (arch x shape) on the production mesh, all PER-DEVICE, with
one NVIDIA H100 SXM as the device (``nvidia-smi``: "NVIDIA H100 80GB
HBM3, 700.00 W", the card of the port's runs; NVIDIA's data sheet,
dense rates):
    compute    = flops / 989.4e12         (bf16 tensor cores, the dry
                                           run's dtype)
    memory     = bytes_accessed / 3.35e12 (HBM3)
    collective = collective_bytes / 450e9 (NVLink 4, one direction)

The memory term rests on the dry run's ``bytes_accessed``, the unfused
sum of every op's operand and result bytes: an upper bound of what a
fused program moves, and so are ``dominant``, ``step_time_bound_s`` and
``mfu_bound`` where it sets them.  The record says so
(``memory_s_upper_bound``).  The reference's XLA figure for host
devices is of the same kind: at its roofline's probes of qwen3-4b and
deepseek-v2-lite-16b (train_4k) the port's bytes are 0.91-0.92 of it,
and the reference too calls qwen3-4b train_4k memory-bound.

The collective term assumes every collective stays inside one NVLink
node.  A node holds 8 cards, so a model axis of 16 crosses the network
card between nodes; that slower link is not modelled.

Methodology, as the reference's: two reduced-layer clones of the
architecture are dry-run and the metrics extrapolated linearly in the
repeating-unit count,
    m(full) = m(A) + (units_full - units_A) * (m(B) - m(A)) / (uB - uA),
exact for the per-layer terms with embed/logits in the intercept.  The
reference needs the clones because XLA's cost analysis counts a loop
body once; the port's dry run runs and counts every layer
(``scan_unroll`` changes nothing), so the extrapolation equals a direct
count of the full stack, and the clones only save time.
"""
import argparse
import dataclasses
import json
import sys
from typing import Dict, Tuple

PEAK_FLOPS = 989.4e12        # H100 SXM bf16 dense, 700 W
HBM_BW = 3.35e12             # H100 SXM HBM3 bytes/s
LINK_BW = 450e9              # H100 NVLink 4 bytes/s, one direction

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, get_shape


def probe_pair(cfg: ArchConfig) -> Tuple[ArchConfig, float, ArchConfig,
                                         float, float]:
    """(cfg_A, units_A, cfg_B, units_B, units_full)."""
    r = dataclasses.replace
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return (r(cfg, num_layers=k), 1.0, r(cfg, num_layers=2 * k), 2.0,
                cfg.num_layers / k)
    if cfg.family == "encdec":
        return (r(cfg, enc_layers=2, dec_layers=2, num_layers=4), 2.0,
                r(cfg, enc_layers=4, dec_layers=4, num_layers=8), 4.0,
                float(cfg.enc_layers))
    if cfg.family == "moe" and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        return (r(cfg, num_layers=fd + 2), 2.0, r(cfg, num_layers=fd + 4),
                4.0, float(cfg.num_layers - fd))
    return (r(cfg, num_layers=2), 2.0, r(cfg, num_layers=4), 4.0,
            float(cfg.num_layers))


_METRICS = ("flops", "bytes_accessed", "collective_total")


def _extrapolate(mA: Dict, uA: float, mB: Dict, uB: float,
                 uF: float) -> Dict:
    out = {}
    for k in _METRICS:
        slope = (mB[k] - mA[k]) / (uB - uA)
        out[k] = mA[k] + (uF - uA) * slope
        out[k + "_per_layer"] = slope
    coll = {}
    for kind in mA["collective_bytes"]:
        slope = (mB["collective_bytes"][kind]
                 - mA["collective_bytes"][kind]) / (uB - uA)
        coll[kind] = mA["collective_bytes"][kind] + (uF - uA) * slope
    out["collective_bytes"] = coll
    return out


def model_flops(cfg: ArchConfig, shape) -> float:
    """MODEL_FLOPS (global): 6*N_active*D for train, 2*N_active*D for
    prefill, 2*N_active*B for one decode step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def roofline_one(arch: str, shape_name: str, multi_pod: bool = False,
                 verbose: bool = True, variant: str = "",
                 **dryrun_kw) -> Dict:
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun as dr

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    cfgA, uA, cfgB, uB, uF = probe_pair(cfg)

    def run(probe_cfg):
        # register the probe clone under its own name while it runs
        registry._ARCHS[probe_cfg.name] = probe_cfg
        try:
            return dr.dryrun_one(probe_cfg.name, shape_name, multi_pod,
                                 verbose=False, unroll=True, **dryrun_kw)
        finally:
            registry._ARCHS.pop(probe_cfg.name, None)

    mA = run(dataclasses.replace(cfgA, name=arch + "#probeA"))
    mB = run(dataclasses.replace(cfgB, name=arch + "#probeB"))
    full = _extrapolate(mA, uA, mB, uB, uF)

    n_dev = 512 if multi_pod else 256
    terms = {
        "compute_s": full["flops"] / PEAK_FLOPS,
        "memory_s": full["bytes_accessed"] / HBM_BW,
        "collective_s": full["collective_total"] / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) / n_dev
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "variant": variant,
        "hlo_flops_per_dev": full["flops"],
        "hlo_bytes_per_dev": full["bytes_accessed"],
        "collective_bytes_per_dev": full["collective_total"],
        "collective_breakdown": full["collective_bytes"],
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_dev": mf,
        "useful_ratio": mf / full["flops"] if full["flops"] else 0.0,
        "memory_s_upper_bound": True,
        "step_time_bound_s": max(terms.values()),
        "mfu_bound": mf / PEAK_FLOPS / max(terms.values())
        if max(terms.values()) else 0.0,
        "probe_compile_s": mA["compile_s"] + mB["compile_s"],
    }
    if verbose:
        print(f"[roofline] {arch} x {shape_name}"
              + (f" [{variant}]" if variant else "") + ": "
              f"compute={terms['compute_s']:.3e}s "
              f"memory<={terms['memory_s']:.3e}s "
              f"collective={terms['collective_s']:.3e}s "
              f"dominant={rec['dominant']} "
              f"useful={rec['useful_ratio']:.2f} "
              f"mfu_bound={rec['mfu_bound']:.2%}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]
    results, failures = [], []
    for a in archs:
        for s in shapes:
            try:
                results.append(roofline_one(a, s, args.multi_pod))
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((a, s, repr(e)[:300]))
                print(f"[roofline] {a} x {s}: FAIL {e!r}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
    print(f"[roofline] {len(results)} OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
