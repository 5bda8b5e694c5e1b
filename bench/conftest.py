"""Fixtures of the benchmark's CPU tests: a tiny cell of the real
configuration and traffic files, cut to CPU size."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def tiny(cell):
    """``cell`` cut to seconds of CPU: four small members on 1-s
    windows, 8 beds, a short window and few trees."""
    cell.config = dict(cell.config, members=[
        "lead1_w8_b2", "lead2_w8_b2", "lead3_w16_b2", "lead1_w16_b4"],
        window_seconds=1, vitals_hz=4, vitals_trees=3, labs_steps=50,
        side_fit_rows=64)
    cell.traffic = dict(cell.traffic, beds=8,
                        pre_seconds=0.5, drain_seconds=5.0, pool_chunks=64,
                        chunk_seconds=0.2, trace_seconds=0.3)
    return cell


@pytest.fixture
def tiny_cell():
    from bench.harness.cells import load_cell
    return tiny(load_cell("zoo12-steady"))


@pytest.fixture
def tiny_herd():
    """The clock-aligned mix (``herd-64``, a ready mix no cell runs yet)."""
    from bench.harness.cells import BENCH, load_cell, load_json
    cell = load_cell("zoo60-steady")
    cell.traffic = load_json(BENCH / "traffic" / "herd-64.json")
    return tiny(cell)
