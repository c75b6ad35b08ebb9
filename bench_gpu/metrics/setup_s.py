"""Set-up: process start to the window (imports, CUDA start, the kernels
loaded from the build cache or built, the world and scene, warm-up)."""


def read(run):
    return run.records["setup_s"]
