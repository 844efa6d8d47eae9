"""device.idle_on_host_share: the share of the window in which no kernel,
copy or memset ran on the card while the dispatcher was in no span or in
any span but ``serve.wait_input``: device idle time the host path, not
the lack of input, accounts for."""

from portbench import spans


def read(ctx):
    w = spans.window_of(ctx)
    if w is None or w.hi <= w.lo:
        return None
    idle = w.idle_by_span()
    if idle is None:
        return None
    on_host = sum(v for k, v in idle.items() if k != "serve.wait_input")
    return on_host / (w.hi - w.lo) * 100.0
