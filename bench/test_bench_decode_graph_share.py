"""The reader of ``decode_graph_share``: the share of a window's decode
steps whose ``lm.step`` tree counts ``graph_replays`` above 0, on step
trees made by hand."""
import pytest

from bench.harness.cells import reader
from repro_torch.obs.spans import SpanTree


def _steps(*replays):
    """One ``lm.step`` tree a count of replayed graphs (None: a tree
    without the counter)."""
    out = []
    for n in replays:
        tree = SpanTree("lm.step")
        tree.counts = {"kv_positions": 8 * 13 * 3700, "launches": 13}
        if n is not None:
            tree.counts["graph_replays"] = n
        out.append(tree)
    return out


@pytest.mark.parametrize("replays,want", [
    ((41, 41, 41), 100.0),          # every step replayed
    ((0, 0), 0.0),                  # every step eager
    ((0, 41, 41, 41), 75.0),        # the first eager, then replays
])
def test_share_of_replayed_steps(replays, want):
    assert reader("decode_graph_share")({"steps": _steps(*replays)}) == want


@pytest.mark.parametrize("obs", [{}, {"steps": []},
                                 {"steps": _steps(None, None)},
                                 {"steps": _steps(41, None)}],
                         ids=["no_steps", "empty", "no_counter",
                              "a_tree_without_it"])
def test_nothing_to_read(obs):
    """No window steps, or a step tree without the counter (a program
    that does not count it): nothing."""
    assert reader("decode_graph_share")(obs) is None
