"""Shared fixtures.  NOTE: no XLA_FLAGS by default — smoke tests and
benches must see the single real CPU device; only launch/dryrun.py
forces 512 placeholder devices (and runs in its own process).

The EXCEPTION is the multi-device lane: setting ``REPRO_MULTI_DEVICE=1``
(or exporting ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
directly, as the CI lane does) forces 8 host devices BEFORE jax
initialises, so the ``multi_device``-marked placement tests run
in-process.  In the default single-device lane those tests skip and
``test_placement_serving.py``'s subprocess wrapper re-runs them in a
child with the flag set.

Heavy integration tests carry ``@pytest.mark.slow`` (registered below) so
``pytest -m "not slow"`` gives a fast signal; the shared zoo fixtures are
session-scoped so the default run builds/trains each zoo exactly once.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# env-guarded multi-device lane: must happen before anything imports jax
if os.environ.get("REPRO_MULTI_DEVICE"):
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy integration test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "multi_device: needs >= 8 forced host devices (XLA_FLAGS / "
        "REPRO_MULTI_DEVICE lane, or the subprocess wrapper in "
        "test_placement_serving.py)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's CUDA "
        "kernels); skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def icu_data():
    from repro.training.data import make_icu_dataset, split_by_patient
    data = make_icu_dataset(n_patients=12, clips_per_patient=8, seed=0,
                            seconds=3)
    return split_by_patient(data, holdout=4)


@pytest.fixture(scope="session")
def small_zoo():
    """Trained reduced zoo + extras (cached on disk by zoo_setup);
    shared session-wide by integration/serving tests."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks.zoo_setup import build_zoo
    return build_zoo(n_patients=12, clips=6, steps=60, seconds=3,
                     verbose=False)


@pytest.fixture(scope="session")
def zoo_members():
    """Randomly-initialised reduced-zoo members (short clips) — the
    shared substrate for fused-serving/equivalence tests, where member
    WEIGHTS don't matter but shapes and bucketing do."""
    import jax
    from repro.configs.ecg_zoo import zoo_specs
    from repro.models.ecg_resnext import init_ecg
    from repro.serving.pipeline import ZooMember
    specs = zoo_specs(reduced=True, input_len=250)
    return [ZooMember(s, init_ecg(jax.random.PRNGKey(i), s))
            for i, s in enumerate(specs)]
