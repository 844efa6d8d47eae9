"""out_samples_per_s: output samples (frames x channels) that all clients
received inside the window, over the window's seconds."""


def read(ctx):
    return ctx["out_samples"] / ctx["seconds"]
