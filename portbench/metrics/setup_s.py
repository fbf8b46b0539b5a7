"""Set-up seconds: process start to the window's start (imports, CUDA
context, the kernels' library, the plan, the input pools and the warm-up)."""


def read(run):
    return run.setup_s
