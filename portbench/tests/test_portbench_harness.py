"""The harness on the CPU: everything BENCHMARK.json names loads by name,
the result line's keys, the trace reduction, the JAX check, and planted
faults that must turn ``correct`` false."""
import copy
import dataclasses
import json
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import check, harness, spec, trace
from portbench import run as run_py
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert not m["name"].endswith("roofline") or m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert spec.load_module("entries", cell.entry).SPANS
    assert callable(spec.load_module("references", cell.entry).transform)
    assert [m["name"] for m in cell.end_to_end] == ["gflops", "step_p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [m["name"] for m in BENCH["per_layer"]]
    assert set(cell.limits) == {"fwd_rel_rms", "fwd_max_err", "inv_rel_rms", "inv_max_err"}


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in BENCH[k]])
def test_every_metric_loads_by_name(metric):
    assert callable(spec.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert config["reduced"] == [] and len(config["source"]) <= 200


def _tiny_cell():
    """n2p20.batch20's configuration and traffic at N = 1024, 8 rows a call."""
    cell = copy.deepcopy(spec.load_cell("n2p20.batch20"))
    cell.config["n"] = 1024
    cell.traffic.update(rows_per_call=8, pool_bytes=3 * 8192 * 4)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    torch.set_num_threads(1)
    cell = _tiny_cell()
    result = harness.run(cell, 2**31 + 3, 0.6, trace, torch.device("cpu"), time.perf_counter())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(cell.limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:  # the CPU trace has no device operations: only the host span's metric
        assert set(result["metrics"]) == {"enqueue_ms"}
        assert result["device"]["window_s"] > 0 and "breakdown" in result
    else:
        assert set(result["metrics"]) == {"gflops", "step_p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result, allow_nan=False)
    lines = run_py.check_lines(result)
    assert len(lines) == 4 and all(line.endswith(" ok") for line in lines)


def _faulted(fault):
    """The real entry's calls with ``fault`` applied to every output."""
    def make(config):
        calls = spec.load_module("entries", "c2c").make(config)
        return {d: (lambda re, im, f=f: fault(re, im, *f(re, im))) for d, f in calls.items()}
    return make


def _half_batch(re, im, o_re, o_im):
    o_re, o_im = o_re.clone(), o_im.clone()
    h = o_re.shape[0] // 2
    o_re[h:], o_im[h:] = 0, 0
    return o_re, o_im


def _one_element(re, im, o_re, o_im):
    o_re = o_re.clone()
    o_re[0, 5] += o_re[0].float().square().mean().sqrt().to(o_re.dtype) * 2
    return o_re, o_im


@pytest.mark.parametrize("fault", [
    lambda re, im, o_re, o_im: (re, im),                 # the state returned unchanged
    _half_batch,                                        # half of the batch left out
    _one_element,                                       # an answer altered where produced
    lambda re, im, o_re, o_im: (o_im, o_re),             # planes swapped
], ids=["unchanged", "half_batch", "one_element", "swapped"])
def test_planted_faults_turn_correct_false(fault):
    torch.set_num_threads(1)
    result = harness.run(_tiny_cell(), 9, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), make_calls=_faulted(fault))
    assert result["correct"] is False and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_window_runs_at_least_one_step():
    result = harness.run(_tiny_cell(), 9, 0.0, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True and result["steps"] == 1 and result["attempted"] == 2


def test_reservoir_is_seeded_and_bounded():
    def sample(seed):
        r = check.Reservoir(4, random.Random(seed))
        for i in range(1000):
            r.offer(i)
        return r.items
    assert sample(5) == sample(5) and len(sample(5)) == 4 and sample(5) != sample(6)
    assert check.sample_size(256 << 20) == 2 and check.sample_size(4 << 20) == 16


def test_trace_reduction():
    # Two steps of one call each; the device runs 10 us of each 40 us call.
    spans = [(0, 50, "step"), (0, 40, "fft_split"), (40, 50, "synchronize"),
             (60, 110, "step"), (60, 100, "fft_split"), (100, 110, "synchronize")]
    ops = [(20, 30, "k"), (35, 45, "k"), (80, 90, "k"), (95, 105, "k")]
    t = Trace(window=(0, 110), device_ops=ops, spans=spans, call_bounds={"fft_split": 5e-6})
    assert t.busy() == [(20, 30), (35, 45), (80, 90), (95, 105)]
    assert t.busy_s == pytest.approx(40e-6) and t.window_s == pytest.approx(110e-6)
    b = t.breakdown()
    assert b["device_ops"] == [["k", pytest.approx(40e-6)]]
    idle = dict(b["idle_gaps"])
    assert idle["fft_split"] == pytest.approx(50e-6)      # 0-20, 30-35, 60-80, 90-95
    assert idle["synchronize"] == pytest.approx(10e-6)    # 45-50, 105-110
    assert idle["between_steps"] == pytest.approx(10e-6)  # 50-60
    # Busy 20 us a traced step against an untraced step of 25 us: 20 % idle.
    run = harness.Run(setup_s=1.0, window_s=1.0, step_times=[1.0], flops=1.0, trace=t,
                      untraced_step_times=[20e-6, 30e-6],
                      untraced_call_times=[10e-6, 20e-6, 30e-6, 60e-6])
    assert spec.load_module("metrics", "device_idle_pct").read(run) == pytest.approx(20.0)
    assert spec.load_module("metrics", "kernels_roofline").read(run) == pytest.approx(100 * 10 / 40)
    assert spec.load_module("metrics", "enqueue_ms").read(run) == pytest.approx(0.03)
    quiet = dataclasses.replace(run, untraced_step_times=[], untraced_call_times=[])
    assert spec.load_module("metrics", "device_idle_pct").read(quiet) is None
    assert spec.load_module("metrics", "enqueue_ms").read(quiet) is None


def test_forbidden_names_compare_whole():
    assert run_py.forbidden_modules(["tensorfft_tpu_torch", "tensorfft_tpu_torch.fft",
                                     "jaxtyping", "numpy"]) == []
    assert run_py.forbidden_modules(["tensorfft_tpu.plan", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "tensorfft_tpu"]


def test_harness_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from portbench import harness, spec; from portbench import run as r; "
            "cell = spec.load_cell('n2p20.batch20'); cell.config['n'] = 256; "
            "cell.traffic.update(rows_per_call=2, pool_bytes=4096); "
            "harness.run(cell, 1, 0.2, True, torch.device('cpu'), time.perf_counter()); "
            "[spec.load_module('metrics', m['name']) for m in cell.end_to_end + cell.per_layer]; "
            "print('FOUND', r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert "FOUND []" in out


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "n16384.bulk",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    # Nor from a directory that holds only BENCHMARK.json and the harness.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "n16384.bulk",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_parse_realigns_a_drifting_device_clock(tmp_path):
    """Device timestamps that drift from the host's by 500 ppm are brought
    back so each step's first kernel starts its launch latency after its
    launch, and the idle time lands under the span that was open."""
    events, corr = [], 0
    for i in range(20):
        t = 10_000.0 * i
        events.append({"ph": "X", "cat": "user_annotation", "name": "step", "ts": t, "dur": 5000})
        events.append({"ph": "X", "cat": "user_annotation", "name": "fft_split", "ts": t, "dur": 100})
        events.append({"ph": "X", "cat": "user_annotation", "name": "synchronize",
                       "ts": t + 100, "dur": 4900})
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": t + 90, "dur": 5, "args": {"correlation": corr}})
        start = t + 90 + trace.LAUNCH_LATENCY_US - 300 + 5e-4 * t  # skewed and drifting
        events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": start, "dur": 4000,
                       "args": {"correlation": corr}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.parse(str(path), {"fft_split": 1e-6})
    for i, (start, end, _) in enumerate(t.device_ops):
        assert start == pytest.approx(10_000.0 * i + 90 + trace.LAUNCH_LATENCY_US, abs=1e-6)
        assert end - start == pytest.approx(4000)
    idle = dict(t.breakdown()["idle_gaps"])
    assert idle["fft_split"] == pytest.approx(20 * (90 + trace.LAUNCH_LATENCY_US) * 1e-6)
