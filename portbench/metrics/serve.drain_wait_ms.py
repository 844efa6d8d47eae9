"""serve.drain_wait_ms: the dispatcher's wait on a step's download a step
in the window (``ServeStats.drain_wall_s`` delta over the ``steps``
delta)."""


def read(ctx):
    w = ctx["window"]
    if not w["steps"]:
        return None
    return w["drain_wall_s"] / w["steps"] * 1e3
