"""95th percentile of every step's host-clock time in the window (a step's
start to the end of its synchronize), in ms."""
import numpy as np


def read(run):
    return float(np.percentile(run.step_times, 95)) * 1e3
