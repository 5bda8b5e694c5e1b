"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
under ``build/repro_torch_kernels/`` at the root of the checkout, named by
a hash of the sources and flags so an edited source never loads a stale
build.  Nothing is built at import: the first kernel launch builds, so the
CPU tests (which never launch) import every module without ``nvcc``.

No source includes PyTorch's headers: the C entry points take raw
pointers, sizes and a ``cudaStream_t`` and return ``cudaGetLastError()``
after the launch, so a build takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
    # buf, patients, ends, valid, out, dims (int[5]: N, C, cap, P, L),
    # stream
    "window_gather_f32": ([_P] * 5 + [ctypes.POINTER(_I), _P], _I),
    # x, w, b, y, dims (int[11]: M, B, L, Cin, K, cin_g, Cout, groups,
    # stride, lo, L_out), force_direct, stream
    "conv1d_stripe_f32": ([_P] * 4 + [ctypes.POINTER(_I), _I, _P], _I),
    # M, B, Cin, K, cin_g, Cout, groups, stride -> 0 direct, 1 depthwise,
    # 2 tiled
    "conv1d_stripe_path": ([_I] * 8, _I),
    # q, k, v, qpos, kpos, out, B, S, T, Hq, Hkv, D, Dv, causal, window,
    # scale, stream
    "flash_attention_f32": ([_P] * 6 + [_I] * 9 + [ctypes.c_float, _P],
                            _I),
    # q, k, v, qpos, kpos, scratch (or null), out, dims (int64[19]: B, T,
    # Hq, Hkv, D, Dv, k strides (b, t, h), v strides (b, t, h), causal,
    # window, ts, n_split, v_in_k, ring slots, path), scale, stream
    "decode_attention_f32": ([_P] * 7 + [ctypes.POINTER(_LL),
                                          ctypes.c_float, _P], _I),
    # g, D, Dv, v_in_k, slots, path (-1: pick), out (int[3]: path, shared
    # memory bytes, P @ V key groups)
    "decode_attention_plan": ([_I] * 6 + [ctypes.POINTER(_I)], _I),
    # x, dt, A, B, C, D, h0 (or null), y, hT, scratch, batch, S, H, P,
    # G, N, chunk, stream
    "ssd_f32": ([_P] * 10 + [_I] * 7 + [_P], _I),
    # xbuf, w_gate, w_up, w_down, hbuf (scratch), rows (int32 scratch,
    # streaming path only, else null), y, E, C, d, f, stream
    "moe_gmm_f32": ([_P] * 7 + [_I] * 4 + [_P], _I),
}


_capturing = threading.local()
COUNTERS: List["LaunchCount"] = []     # every kernel's, in import order


class LaunchCount:
    """A wrapper's launch counter: one per kernel entry point, bumped
    where the kernel launches.  A wrapper called inside a CUDA graph's
    capture launches nothing: on a thread inside ``CaptureLaunches``
    its bump goes to that capture's tally, and whoever replays the
    graph ``add``s the tally back at every replay, which is where the
    kernels run."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()    # server workers launch together
        COUNTERS.append(self)

    def bump(self) -> None:
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + 1
            return
        self.add(1)

    def add(self, n: int) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


def total_launches() -> int:
    """The launches every kernel wrapper has counted so far."""
    return sum(c.value for c in COUNTERS)


class CaptureLaunches:
    """Around a CUDA graph's capture: the wrappers this thread calls
    count into the tally ``with`` yields (counter -> launches a
    replay), not into their counters, so a capture counts nothing and
    another thread's launches never reach the tally."""

    def __enter__(self) -> Dict[LaunchCount, int]:
        _capturing.tally = self.tally = {}
        return self.tally

    def __exit__(self, *exc) -> None:
        _capturing.tally = None


# the caching allocator keeps one CUDA graph capture underway a process
# at a time: every capture holds this lock
CAPTURE_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME",
                                             "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot "
                       "be built")


class _Library:
    """The process-wide handle on the built kernel library."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None
        self.build_seconds = 0.0
        self.log = ""                      # nvcc/ptxas output of a build

    def sources(self) -> List[Path]:
        return sorted(CSRC.glob("*.cu"))

    def _tag(self, srcs: List[Path]) -> str:
        h = hashlib.sha256(" ".join(CFLAGS).encode())
        for s in srcs + sorted(CSRC.glob("*.cuh")):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        return h.hexdigest()[:16]

    def _build(self, out: Path, srcs: List[Path]) -> None:
        nvcc = _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"tmp-{os.getpid()}-{out.stem}"
        tmp.mkdir(exist_ok=True)
        objs = [tmp / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc] + CFLAGS + ["-I", str(CSRC), "-c", str(s), "-o",
                               str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        self.log = "".join(logs)
        bad = [(s.name, p.returncode, lg) for s, p, lg
               in zip(srcs, procs, logs) if p.returncode]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n} (rc {rc})\n{lg}" for n, rc, lg in bad))
        so = tmp / out.name
        link = subprocess.run(
            [nvcc] + ARCH + ["-shared", "-o", str(so)]
            + [str(o) for o in objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, out)              # atomic against a racing build
        shutil.rmtree(tmp, ignore_errors=True)

    def get(self) -> ctypes.CDLL:
        """Build (if this checkout has no build of these sources yet)
        and load the library.  Raises when the build fails."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                srcs = self.sources()
                out = BUILD_DIR / f"librepro_torch_kernels-" \
                                  f"{self._tag(srcs)}.so"
                if not out.exists():
                    t0 = time.perf_counter()
                    self._build(out, srcs)
                    self.build_seconds = time.perf_counter() - t0
                lib = ctypes.CDLL(str(out))
                for name, (args, res) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = res
                self.path = out
                self._lib = lib
        return self._lib


LIBRARY = _Library()


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc:
        msg = LIBRARY.get().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s card
    (the integer ``torch.cuda.current_stream(t.device).cuda_stream``
    gives, without building a ``Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def no_backward(name: str) -> RuntimeError:
    """The error a wrapper raises, before anything else, when grad is on
    and an input requires grad: the kernel fills its output through
    ``ctypes``, so the output would carry no ``grad_fn`` and every
    weight upstream would silently get no gradient."""
    return RuntimeError(
        f"{name}: the CUDA kernel has no backward, and an input requires "
        "grad; training runs the plain versions (impl='torch', as the "
        "reference trains through impl='xla'), or call under "
        "torch.no_grad()")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The kernels run on the card only: a CPU tensor is an error here
    (``kernels.ops`` sends CPU tensors to the plain versions)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                             f"got a tensor on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel needs contiguous "
                             f"tensors (got strides {t.stride()})")
    return dev
