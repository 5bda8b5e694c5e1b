"""The port's rules, checked mechanically.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of the JAX package (``repro``);
* the kernel modules and ``chip_smoke.py`` hold no ``try``: nothing
  catches a kernel build or launch to fall back to the plain version;
* an entry point built without ``device=`` runs on the card, so it
  raises when CUDA is absent;
* a CPU tensor handed to a kernel wrapper raises instead of running the
  plain version.
"""
import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.ecg_zoo import zoo_specs
from repro_torch.device import resolve_device
from repro_torch.kernels import conv1d_stripe as kconv
from repro_torch.kernels import ops
from repro_torch.kernels import window_gather as kgather
from repro_torch.models.ecg_resnext import init_ecg
from repro_torch.serving import aggregator as ta
from repro_torch.serving import pipeline as tp

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


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


def test_no_try_around_kernels_or_in_chip_smoke():
    files = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py")) \
        + [ROOT / "chip_smoke.py"]
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
    assert resolve_device("cpu") == torch.device("cpu")
    assert tp.EnsembleService([_member()], device="cpu").device.type == "cpu"


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


def test_cpu_service_with_cuda_impl_raises_not_falls_back():
    svc = tp.EnsembleService([_member()], impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        svc.predict({"ecg": np.zeros((3, 250), np.float32)})
