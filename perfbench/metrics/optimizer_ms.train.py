"""Host ms a step inside the optimizer's ``tx.update`` over the window's
steps, by the host's clock around each call (a wait on a full launch
queue included)."""


def read(r):
    return r.window.get("optimizer_ms")
