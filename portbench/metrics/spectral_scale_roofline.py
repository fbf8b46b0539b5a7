"""Share of its roofline reached by the spectral scale of the Poisson solve,
in %: the compulsory-byte bound of every traced launch of
``tfft::poisson_scale_kernel`` (both half-spectrum planes of the grid of
the configuration of the cells that list this metric read once and
written once, ``r2c_work.py``; 539 MB, 0.161 ms at 512^3 in bf16; cells of
different grids are refused) over their summed device time.  None when
the trace holds no launch of it."""
from pathlib import Path

from portbench import peaks, r2c_work

KERNEL = "tfft::poisson_scale_kernel"


def read(run):
    if run.trace is None:
        return None
    config = r2c_work.metric_config(Path(__file__).stem)
    times = [(end - start) * 1e-6 for start, end, name in run.trace.device_ops
             if KERNEL in name]
    if not times or sum(times) <= 0:
        return None
    bound = len(times) * r2c_work.scale_bytes(config["shape"], config["precision"])
    return 100.0 * bound / peaks.HBM_BYTES_PER_S / sum(times)
