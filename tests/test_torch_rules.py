"""The port's rules, checked mechanically.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of the JAX package (``repro``);
* the kernel modules, the LM paths' modules (dense, MoE, SSM, hybrid,
  enc-dec, and the mesh tools the sharded MoE runs over), the
  training path's modules, the entry points (``examples/``) with the
  benchmark functions they call, and ``chip_smoke.py`` hold no ``try``:
  nothing catches a kernel build or launch to fall back to the plain
  version.  ``launch/dryrun.py`` and ``launch/roofline.py`` stay off
  that list: as the reference's, their ``main`` catches a failed
  (arch, shape) combination, reports it and goes on, then exits 1, and
  a dry run tears its fake process group down in a ``finally``; they
  run the plain versions on fake tensors and launch no kernel;
* an entry point built without ``device=`` runs on the card, so it
  raises when CUDA is absent; the example mains raise without
  ``--device cpu`` before any zoo build;
* a CPU tensor handed to a kernel wrapper raises instead of running the
  plain version;
* a kernel wrapper handed an input that requires grad, with grad on,
  raises before anything else (the kernels have no backward), and runs
  its checks as before under ``torch.no_grad()``.
"""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.benchmarks import adaptive_bench
from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.device import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.benchmarks import zoo_setup
from repro_torch.examples import compose_ensemble, quickstart, serve_icu
from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import moe_gmm as kgmm
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as kssd
from repro_torch.kernels import window_gather as kgather
from repro_torch.launch import mesh, serve
from repro_torch.launch import train as launch_train
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.ecg_resnext import init_ecg
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp
from repro_torch.training import train_loop
from repro_torch.training.data import lm_batches

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the LM serving paths (dense, MoE, pure SSM, hybrid, enc-dec), from the
# launcher down to the kernel wrappers
LM_PATH = [PORT / f for f in (
    "launch/serve.py", "models/api.py", "models/transformer.py",
    "models/attention.py", "models/layers.py", "models/runtime.py",
    "models/convert.py", "models/ssm.py", "models/moe.py",
    "models/hybrid.py", "models/encdec.py",
    "configs/base.py", "configs/registry.py", "configs/qwen3_4b.py",
    "configs/smollm_360m.py", "configs/mamba2_2p7b.py",
    "configs/phi35_moe_42b.py", "configs/zamba2_7b.py",
    "configs/seamless_m4t_medium.py", "kernels/ops.py", "kernels/ref.py",
    "kernels/flash_attention.py", "kernels/ssd.py", "kernels/moe_gmm.py",
    "kernels/conv1d_stripe.py", "launch/mesh.py", "launch/sharding.py",
    "launch/specs.py", "configs/shapes.py")]
# the training path: the train loops, the optimizer, checkpoints, data,
# the launcher, the zoo builder and its example
TRAIN_PATH = [PORT / f for f in (
    "training/__init__.py", "training/data.py", "training/optimizer.py",
    "training/checkpoint.py", "training/train_loop.py", "launch/train.py",
    "benchmarks/zoo_setup.py", "examples/train_ecg_zoo.py")]
# the system's entry points and the benchmark functions they call
ENTRY_PATH = [PORT / f for f in (
    "examples/serve_icu.py", "examples/quickstart.py",
    "examples/compose_ensemble.py", "benchmarks/adaptive_bench.py",
    "benchmarks/composition.py")]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_lm_path_modules_are_checked():
    assert set(LM_PATH) <= set(PORT_FILES)
    assert set(TRAIN_PATH) <= set(PORT_FILES)
    assert set(ENTRY_PATH) <= set(PORT_FILES)


def test_no_try_around_kernels_or_in_chip_smoke():
    files = sorted((PORT / "kernels").glob("*.py")) + LM_PATH \
        + TRAIN_PATH + ENTRY_PATH + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
            path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _member():
    spec = zoo_specs(reduced=True, input_len=250)[0]
    return tp.ZooMember(spec, init_ecg(spec, torch.Generator()
                                       .manual_seed(0)))


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    mods = [ta.ModalitySpec("ecg", 250.0, 3)]
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.EnsembleService([_member()])
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.DeviceIngest(mods, 2, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.StreamingPipeline(None, 2, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.agg_init(2, 3, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_host_mesh()
    assert not dist.is_initialized()
    cfg = get_config("qwen3-4b-reduced")
    for arch in ("qwen3-4b-reduced", "mamba2-2.7b-reduced",
                 "phi3.5-moe-42b-a6.6b-reduced", "zamba2-7b-reduced",
                 "seamless-m4t-medium-reduced"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--new-tokens", "1"])
    for mod, init, arch in (
            (transformer, transformer.init_lm, "qwen3-4b-reduced"),
            (hybrid, hybrid.init_hybrid, "zamba2-7b-reduced"),
            (encdec, encdec.init_encdec, "seamless-m4t-medium-reduced")):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(torch.Generator(), get_config(arch), RuntimeOptions())
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.init_cache(get_config(arch), RuntimeOptions(), 1, 8)
    spec = zoo_specs(reduced=True, input_len=250)[0]
    x, y = np.zeros((4, 250), np.float32), np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.train_ecg_model(spec, x, y, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.train_lm(cfg, RuntimeOptions(),
                            lm_batches(cfg.vocab_size, 1, 8), steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "smollm-360m-reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo_setup.build_zoo(n_patients=4, clips=1, seconds=1, steps=1,
                            widths=(8,), blocks=(2,), verbose=False)
    assert resolve_device("cpu") == torch.device("cpu")
    assert tp.EnsembleService([_member()], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mod", [serve_icu, quickstart, compose_ensemble],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_mains_raise_without_cuda_before_any_build(no_cuda, mod,
                                                           monkeypatch):
    """Without ``--device cpu`` an example resolves ``cuda:0`` first and
    raises, before any zoo build or composition."""
    built = []
    monkeypatch.setattr(mod, "build_zoo", lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    assert not built


def test_hot_swap_defaults_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        adaptive_bench.wallclock_hot_swap(n_queries=1, verbose=False)


def test_resolve_device_names_cuda0_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 1, 8, 4)
    w = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kconv.conv1d_stripe_stacked(x, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kconv.conv1d_stripe(x[0], w[0])
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kgather.window_gather(torch.zeros(1, 3, 8), i, i, i, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.conv1d(x, w, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.window_gather(torch.zeros(1, 3, 8), i, i, i, 4, impl="cuda")
    q, pos = torch.zeros(1, 4, 2, 32), torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kflash.flash_attention(q, q[:, :, :1].contiguous(),
                               q[:, :, :1].contiguous(), pos, pos)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, q, q, pos, pos, impl="cuda")
    xs, dt, h = torch.zeros(1, 4, 2, 8), torch.ones(1, 4, 2), torch.ones(2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kssd.ssd(xs, dt, -h, xs[:, :, :1].contiguous(),
                 xs[:, :, :1].contiguous(), h, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd(xs, dt, -h, xs[:, :, :1], xs[:, :, :1], h, 4, impl="cuda")
    xb, wg = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    wd = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kgmm.moe_gmm(xb, wg, wg, wd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.moe_gmm(xb, wg, wg, wd, impl="cuda")


def test_cpu_service_with_cuda_impl_raises_not_falls_back():
    svc = tp.EnsembleService([_member()], impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        svc.predict({"ecg": np.zeros((3, 250), np.float32)})


def _wrapper_calls(rg):
    """Each kernel wrapper called on small CPU inputs; ``rg`` marks the
    float inputs that require grad."""
    f = lambda *s: torch.zeros(*s).requires_grad_(rg)
    i = torch.zeros(1, dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)
    return {
        "window_gather": lambda: kgather.window_gather(f(1, 3, 8), i, i, i,
                                                       4),
        "conv1d_stripe": lambda: kconv.conv1d_stripe(f(1, 8, 4),
                                                     f(3, 4, 4)),
        "conv1d_stripe_stacked": lambda: kconv.conv1d_stripe_stacked(
            f(2, 1, 8, 4), f(2, 3, 4, 4)),
        "flash_attention": lambda: kflash.flash_attention(
            f(1, 4, 2, 32), f(1, 4, 1, 32), f(1, 4, 1, 32), pos, pos),
        "decode_attention": lambda: kdecode.decode_attention(
            f(1, 2, 32), f(1, 4, 1, 32), f(1, 4, 1, 32), pos, 3),
        "ssd": lambda: kssd.ssd(f(1, 4, 2, 8), f(1, 4, 2), f(2),
                                f(1, 4, 1, 8), f(1, 4, 1, 8), f(2), 4),
        "moe_gmm": lambda: kgmm.moe_gmm(f(2, 3, 4), f(2, 4, 5), f(2, 4, 5),
                                        f(2, 5, 4)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls(False)))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """The guard runs first, so it needs no card: with grad on and an
    input that requires grad, every wrapper raises the guard's error;
    under ``torch.no_grad()`` the same call reaches the wrapper's own
    checks (here: CPU tensors refused)."""
    with pytest.raises(RuntimeError, match="no backward.*plain versions"):
        _wrapper_calls(True)[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _wrapper_calls(True)[name]()
    with pytest.raises(ValueError, match="CUDA"):
        _wrapper_calls(False)[name]()
