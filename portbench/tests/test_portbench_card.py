"""On the card (marked ``gpu``): each cell at its own size, each control in
the program's place comes out not correct on three seeds, and the program
comes out correct.  ``python -m pytest -m gpu portbench/tests``."""
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness, spec, traffic

BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_at_the_cells_size(card, workload):
    cell = spec.load_cell(workload)
    reference = spec.load_module("references", cell.entry)
    dtype = traffic.DTYPES[cell.config["precision"]]
    for control in reference.CONTROLS.values():
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            result = harness.run(cell, seed, 1.0, False, card, time.perf_counter(),
                                 make_calls=lambda c: calibrate.control_calls(control, c, dtype))
            assert result["correct"] is False, result["checks"]
    result = harness.run(cell, 2**31 + 4, 1.0, False, card, time.perf_counter())
    assert result["correct"] is True, result["checks"]
