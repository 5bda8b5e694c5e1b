"""Process start -> window start: imports, the CUDA context, weights,
side models, warm-up, ring prefill, the kernels' build or load, and the
traffic that runs before the window."""


def read(obs):
    return obs["setup_s"]
