"""Share of its roofline reached by the spectral product of the image
convolution, in %: the compulsory-byte bound of every traced launch of
``tfft::spectral_product_kernel`` (both spectra's planes of the frame of the
configuration of the cells that list this metric read once, the product's
two float32 planes written once, ``conv_work.py``; 402,653,184 B, 0.1202 ms
at 4096^2 in float32; cells of different frames are refused) over their
summed device time.  None when the trace holds no launch of it."""
from pathlib import Path

from portbench import conv_work, peaks, r2c_work

KERNEL = "tfft::spectral_product_kernel"


def read(run):
    if run.trace is None:
        return None
    times = [(end - start) * 1e-6 for start, end, name in run.trace.device_ops
             if KERNEL in name]
    if not times or sum(times) <= 0:
        return None
    config = r2c_work.metric_config(Path(__file__).stem)
    bound = len(times) * conv_work.product_bytes(config["shape"], config["precision"])
    return 100.0 * bound / peaks.HBM_BYTES_PER_S / sum(times)
