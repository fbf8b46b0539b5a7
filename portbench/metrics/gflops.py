"""GFLOP/s: 5 N log2 N per transform for every call completed in the window,
over the window's host-clock seconds (its start to the synchronize after its
last step)."""


def read(run):
    return run.flops / run.window_s / 1e9
