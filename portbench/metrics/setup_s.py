"""setup_s: process start to the window's start (imports, CUDA, the
kernels from the build cache, the filter's load and fold, the server's
start with every step shape run once, the generators, the warm-up)."""


def read(ctx):
    return ctx["setup_s"]
