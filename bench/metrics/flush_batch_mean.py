"""Windows a flush over the window (the server's ``MicroBatcher``
counts, read at the window's start and end)."""


def read(obs):
    b = obs.get("batcher")
    if not b or not b["flushes"]:
        return None
    return b["items"] / b["flushes"]
