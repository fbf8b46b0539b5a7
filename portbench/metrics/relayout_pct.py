"""Share of the traced device time spent in operations that are not the
port's own kernels, in %: the device operations whose name lacks ``tfft::``
(the copies and casts that the N-D dispatch's relayout adds between the axis
passes), over the summed time of every device operation in the window.
The device side of the port's ``tfft.nd.relayout`` span."""

PORT = "tfft::"


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    total = other = 0.0
    for start, end, name in run.trace.device_ops:
        total += end - start
        if PORT not in name:
            other += end - start
    return 100.0 * other / total if total > 0 else None
