"""Process start to the window's first call: imports, the CUDA context,
the kernel library's build or load, the scene, one warm call."""


def read(ctx):
    return ctx["setup_s"]
