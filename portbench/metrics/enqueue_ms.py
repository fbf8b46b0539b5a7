"""Mean host time of one call into the program, in ms: the host clock
around each call (no synchronize inside), over the calls of the steps the
profiler did not record, so its cost is not in it."""


def read(run):
    calls = run.untraced_call_times
    if not calls:
        return None
    return sum(calls) / len(calls) * 1e3
