"""Conformance harness: test signals, deviation metrics, fp64 oracle, the
reference sweep (``testing.conformance``), result files (``testing.io``) and
CUDA-event timing."""

from tensorfft_tpu_torch.testing.datagen import (
    get_random_weights,
    make_test_signal,
    sine_superposition,
    sine_superposition_torch,
)
from tensorfft_tpu_torch.testing.metrics import (
    Agreement,
    agreement,
    Deviation,
    deviation,
    REFERENCE_AVG_THRESHOLD,
    REFERENCE_MAX_THRESHOLD,
    REFERENCE_SIGMA_THRESHOLD,
)
from tensorfft_tpu_torch.testing.oracle import fft_oracle, fftn_oracle, torch_baseline
from tensorfft_tpu_torch.testing.timer import BenchResult, measure
