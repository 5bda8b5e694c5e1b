"""PyTorch/CUDA port of the HOLMES ECG ensemble serving path.

Mirrors ``repro``'s module layout; every Pallas TPU kernel on the ported
path has a hand-written CUDA kernel under ``kernels/csrc`` with a plain
PyTorch version beside it.  Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"`` (see ``device.resolve_device``).
"""
