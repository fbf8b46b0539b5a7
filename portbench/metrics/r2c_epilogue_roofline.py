"""Share of the roofline reached by the real-to-complex epilogue kernels of
the traced solves, in %: the sum of the compulsory-byte bound of every
traced launch of ``tfft::pack_kernel`` (K7), ``tfft::untangle_pairs_kernel``
(K9), ``tfft::retangle_pairs_kernel`` (K10) and ``tfft::interleave_kernel``
(K8), each on the grid of the configuration of the cells that list this
metric (``r2c_work.py``: about 16 bytes a grid point a solve, over the HBM
bandwidth; cells of different grids are refused), over their summed
device time.  None when the trace holds none of them."""
from pathlib import Path

from portbench import peaks, r2c_work

KERNELS = {"tfft::pack_kernel": "pack", "tfft::untangle_pairs_kernel": "untangle",
           "tfft::retangle_pairs_kernel": "retangle", "tfft::interleave_kernel": "interleave"}


def read(run):
    if run.trace is None:
        return None
    config = r2c_work.metric_config(Path(__file__).stem)
    nbytes = r2c_work.epilogue_bytes(config["shape"], config["precision"])
    bound = device_s = 0.0
    for start, end, name in run.trace.device_ops:
        kernel = next((k for key, k in KERNELS.items() if key in name), None)
        if kernel is not None:
            bound += nbytes[kernel] / peaks.HBM_BYTES_PER_S
            device_s += (end - start) * 1e-6
    return 100.0 * bound / device_s if device_s > 0 else None
