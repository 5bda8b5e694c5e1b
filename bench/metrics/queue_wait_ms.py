"""Mean milliseconds a query due in the window spent queued and
coalescing before its flush began (``SpanRecord`` queue_s +
coalesce_s)."""


def read(obs):
    spans = obs.get("spans")
    if not spans:
        return None
    return 1e3 * sum(s.queue_s + s.coalesce_s for s in spans) / len(spans)
