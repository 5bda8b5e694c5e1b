"""The flushes behind the window's query spans, from the span trees the
program hangs on each ``SpanRecord`` (``flush``).  A reader takes a
tree's spans by name (``SpanTree.named``) and their seconds from the
program's own ``Span.wall_s`` and ``Span.cpu_s``.

A reader of these trees reports nothing rather than part of a sample:
``window_flushes`` gives ``None`` when a query due in the window has no
span (the recorder dropped it, or it was never answered) or its span no
tree (a program that builds none)."""
from __future__ import annotations

from typing import Dict, List, Optional


def window_flushes(obs: Dict) -> Optional[List]:
    """One span tree a flush that served queries due in the window."""
    spans = obs.get("spans")
    if not spans or len(spans) != len(obs.get("latency_s") or ()):
        return None
    trees = {}
    for s in spans:
        tree = getattr(s, "flush", None)
        if tree is None:
            return None
        trees[id(tree)] = tree
    return list(trees.values())
