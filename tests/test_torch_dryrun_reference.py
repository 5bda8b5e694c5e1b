"""The port's dry-run counts against the JAX package's compiled ones on
the same 16x16 production mesh (``repro/launch/dryrun.py``).

The reference runs in a subprocess: importing its dry run forces 512
host devices, which a process must set before JAX starts.  There it
lowers and compiles the train step as its ``dryrun_one`` does, with
``scan_unroll=True`` as its roofline's probes do (XLA's cost analysis
counts a loop body once), and reads from the compiled HLO the flops of
every dot and convolution and the result elements of every collective,
by kind.

The cases are the roofline's own probes at full width, train_4k:
qwen3-4b at 2 layers, and deepseek-v2-lite-16b at its dense layer and
2 MoE layers under ``moe_impl="gspmd"``.  The reduced archs have 4
query heads, which a model axis of 16 does not divide: GSPMD then splits
the heads and the head dim 4 x 4, where the port gathers the heads
(PERF.md §6), and the reference raises on qwen3-4b-reduced
(``kv_mult`` 8 gives 4 query heads 16 KV heads).  The reference's
``"shard_map"`` train step raises under this JAX ("Contracting
dimensions are sharded"); the port's shard_map step is held to the
reference's gspmd matmul flops, which it must equal, since both compute
the experts on local tokens with f-sharded weights.

Bands:
* matmul flops (the port's flop registry: mm, bmm, convolution,
  attention) equal the reference's dot and convolution flops within
  1e-9 relative;
* the reference's ``flops`` (XLA's cost analysis, which also counts one
  flop an element of every elementwise op and reduction) lie 0-3 %
  above them;
* all-reduce elements within 5 % of the reference's; the kinds the
  reference issues none of hold under 1 % of the port's total, and an
  all-gather the reference issues (GSPMD gathers the router's
  probabilities over the batch for its ``top_k``) holds under 3 % of
  the reference's total;
* ``bytes_accessed`` (the port's is the unfused sum of every op's
  operand and result bytes; XLA's, after its CPU fusion) within a factor
  of 1.25 either way (the port's was 0.91-0.92 of XLA's).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import dryrun, mesh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (arch, layers, moe_impl of the port's step)
CASES = {"qwen3-4b-2l": ("qwen3-4b", 2, "gspmd"),
         "deepseek-3l": ("deepseek-v2-lite-16b", 3, "gspmd")}

_REFERENCE = r"""
import dataclasses, json, re, sys
from repro.launch import dryrun as d          # forces 512 host devices
import jax
from repro.configs import registry
from repro.configs.shapes import get_shape
from repro.launch import specs as sp
from repro.launch.mesh import make_production_mesh

arch, layers = sys.argv[1], int(sys.argv[2])
cfg = dataclasses.replace(registry.get_config(arch),
                          name=f"{arch}-{layers}l", num_layers=layers)
shape = get_shape("train_4k")
mesh = make_production_mesh(multi_pod=False)
rt = dataclasses.replace(sp.runtime_for(cfg, shape, mesh.shape["model"]),
                         scan_unroll=True, moe_impl="gspmd")
args = sp.input_specs(cfg, shape, rt)
in_sh = d.build_shardings(cfg, shape, rt, mesh, args)
with mesh:
    compiled = jax.jit(d.build_step(cfg, shape, rt),
                       in_shardings=in_sh).lower(*args).compile()
hlo = compiled.as_text()
cost = compiled.cost_analysis()

line_re = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = (.*)$")
array_re = re.compile(r"^(\w+)\[([\d,]*)\]")
shapes, matmul = {}, 0
elements = {k: 0 for k in d._COLLECTIVES}


def dims(text):
    return [int(x) for x in text.split(",") if x]


def prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n


for line in hlo.splitlines():
    m = line_re.match(line)
    if not m:
        continue
    name, rhs = m.groups()
    a = array_re.match(rhs)
    if a:
        shapes[name] = dims(a.group(2))
    op = re.search(r"\s([\w\-]+)\(", rhs)
    op = op.group(1) if op else ""
    if op in ("dot", "convolution"):
        operands = rhs.split(op + "(", 1)[1]
        lhs, rhs_op = re.findall(r"%([\w.\-]+)", operands)[:2]
        if op == "dot":
            k = prod(shapes[lhs][i] for i in dims(re.search(
                r"lhs_contracting_dims=\{([\d,]*)\}", rhs).group(1)))
        else:
            kernel = re.search(r"dim_labels=\w+_(\w+)->", rhs).group(1)
            k = prod(n for c, n in zip(kernel, shapes[rhs_op]) if c != "o")
        matmul += 2 * prod(shapes[name]) * k
    for kind in d._COLLECTIVES:
        if op in (kind, kind + "-start"):
            elements[kind] += sum(prod(dims(s)) for _, s in
                                  d._SHAPE_RE.findall(rhs.split(op + "(")[0]))
json.dump({"flops": float(cost["flops"]),
           "bytes_accessed": float(cost["bytes accessed"]),
           "matmul_flops": float(matmul),
           "collective_elements": elements}, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    """Each case's reference counts, the subprocesses started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, arch, str(layers)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, (arch, layers, _) in CASES.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
        out[k] = json.loads(stdout)
    return out


def _port(arch, layers, moe_impl):
    cfg = dataclasses.replace(registry.get_config(arch),
                              name=f"{arch}-{layers}l", num_layers=layers)
    registry._ARCHS[cfg.name] = cfg
    mesh.teardown()
    try:
        return dryrun.dryrun_one(cfg.name, "train_4k", verbose=False,
                                 rt_overrides={"moe_impl": moe_impl})
    finally:
        registry._ARCHS.pop(cfg.name)
        mesh.teardown()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dryrun_counts_match_the_reference(case, reference):
    ref, got = reference[case], _port(*CASES[case])
    assert abs(got["flops"] - ref["matmul_flops"]) \
        <= 1e-9 * ref["matmul_flops"], (got["flops"], ref)
    assert 1.0 <= ref["flops"] / ref["matmul_flops"] <= 1.03, ref
    r_el, g_el = ref["collective_elements"], got["collective_elements"]
    assert abs(g_el["all-reduce"] - r_el["all-reduce"]) \
        <= 0.05 * r_el["all-reduce"], (g_el, r_el)
    for kind in dryrun._COLLECTIVES:
        if kind != "all-reduce" and not r_el[kind]:
            assert g_el[kind] <= 0.01 * sum(g_el.values()), (kind, g_el)
        if kind != "all-reduce" and not g_el[kind]:
            assert r_el[kind] <= 0.03 * sum(r_el.values()), (kind, r_el)
    ratio = got["bytes_accessed"] / ref["bytes_accessed"]
    assert 1 / 1.25 <= ratio <= 1.25, (got["bytes_accessed"], ref)


def test_shard_map_moe_matches_the_reference_gspmd_matmul_flops(reference):
    """The shard_map step computes the experts on local tokens with
    f-sharded weights, as GSPMD partitions the reference's gspmd step:
    the same matmul flops.  Its collectives differ by design (one
    token-space all-reduce a layer, where GSPMD reduces the dispatch
    buffer)."""
    ref = reference["deepseek-3l"]
    got = _port("deepseek-v2-lite-16b", 3, "shard_map")
    assert abs(got["flops"] - ref["matmul_flops"]) \
        <= 1e-9 * ref["matmul_flops"], (got["flops"], ref)
    assert got["collective_elements"]["all-reduce"] \
        < ref["collective_elements"]["all-reduce"]
