"""Share of the roofline reached by the port's own kernels alone: the sum
of each traced call's bound (``work.py``) over the summed device time of the
operations whose name holds ``tfft::``, in %.  ``kernels_roofline`` divides
by every device operation; this leaves out the relayout's copies
(``relayout_pct``), so the two together split a call's distance from its
bound between the kernels and the copies."""

PORT = "tfft::"


def read(run):
    if run.trace is None:
        return None
    device_s = sum(end - start for start, end, name in run.trace.device_ops
                   if PORT in name) * 1e-6
    if device_s <= 0:
        return None
    bound = sum(run.trace.call_bounds[name] for _, _, name in run.trace.calls())
    return 100.0 * bound / device_s
