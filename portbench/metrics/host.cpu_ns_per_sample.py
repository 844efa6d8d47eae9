"""host.cpu_ns_per_sample: the server process's user and system CPU time
over the window (every thread: serve plane, io, engine; ``os.times``),
over the output samples the clients received in it."""


def read(ctx):
    if not ctx["out_samples"]:
        return None
    return ctx["cpu_s"] / ctx["out_samples"] * 1e9
