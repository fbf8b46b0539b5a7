"""On the card (marked ``gpu``): a traced window of each cell at its own
size has every device operation under one of the port's ``tfft.launch.*``
spans (``program_spans.py``), kernels B and C on rows of their own, and no
table built inside it.  ``python -m pytest -m gpu portbench/tests``."""
import json
from pathlib import Path

import pytest
import torch

from portbench import program_spans, spec

BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
LAUNCHERS = {"n16384.bulk": {"fused_fft"}, "n2p20.batch20": {"four_step_col", "four_step_row"}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_device_op_is_under_a_launch_span(card, workload):
    result = program_spans.measure(spec.load_cell(workload), 2**31 + 5, 1.0, card)
    rows = [name for name, _ in result["breakdown"]["device_ops"]]
    assert {name.split("/")[0] for name in rows} == LAUNCHERS[workload], rows
    assert result["readings"]["tables_built"] == 0
    for name in ("entry_ms", "dispatch_ms", "launch_ms", "idle_in_program_pct"):
        assert result["readings"][name] > 0, name
