"""Share of a step in which no operation runs on the card, in %:
1 - (device busy time per step) / (mean host time of a step).  The busy
time is the union of the device intervals of the traced steps (the trace),
over their number; the step time is the mean of the steps the profiler did
not record, so the profiler's host cost does not read as idle."""


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.untraced_step_times:
        return None
    steps = sum(1 for s in run.trace.spans if s[2] == "step")
    step_s = sum(run.untraced_step_times) / len(run.untraced_step_times)
    return 100.0 * (1.0 - run.trace.busy_s / steps / step_s)
