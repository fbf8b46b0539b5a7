"""Share of the roofline reached by the kernels of the traced calls: the
sum of each call's bound (``work.py``: the larger of its operations over the
operation peak and its compulsory bytes over the HBM bandwidth) over the
summed device time of every device operation in the traced window, in %.
The benchmark launches nothing in the window, so every such operation is a
call's."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    bound = sum(run.trace.call_bounds[name] for _, _, name in run.trace.calls())
    device_s = sum(end - start for start, end, _ in run.trace.device_ops) * 1e-6
    return 100.0 * bound / device_s
