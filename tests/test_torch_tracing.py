"""The port's profiler spans and counters (``tensorfft_tpu_torch/tracing.py``)
on the CPU: no span is made without a profiler, a traced call leaves
``tfft.entry`` around ``tfft.dispatch``, a launch names its span after the C
launcher, and a table build is counted once."""
import collections
import contextlib
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import tensorfft_tpu_torch as tfft
from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.ops import _build, fused_cuda


@pytest.fixture
def record_function_calls(monkeypatch):
    """Count every ``torch.profiler.record_function`` built, and build it."""
    made = []
    real = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return made


def _planes(b=3, n=256):
    gen = torch.Generator().manual_seed(5)
    return torch.randn(b, n, generator=gen), torch.randn(b, n, generator=gen)


def test_no_span_without_a_profiler(record_function_calls):
    plan = tfft.create_plan(256, precision="bfloat16")
    re, im = _planes()
    tfft.ifft_split(*tfft.fft_split(re, im, plan), plan)
    assert tracing.spanned("tfft.entry")(lambda x, y=1: x + y)(2, y=3) == 5
    with tracing.launch_span("tfft_four_step_col"):
        pass
    assert record_function_calls == []


def _chrome_events(prof_path):
    with open(prof_path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _holds(outer, inner):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("strategy", ["fused", "four_step"])
def test_traced_call_nests_dispatch_in_entry(tmp_path, strategy):
    """The benchmark's schedule shape: the active steps' calls each leave one
    ``tfft.entry`` holding one ``tfft.dispatch``."""
    n = 4096
    plan = tfft.create_plan(n, precision="bfloat16", strategy=strategy)
    re, im = _planes(2, n)
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(3):
            tfft.ifft_split(*tfft.fft_split(re, im, plan), plan)
            prof.step()
    spans = _chrome_events(path)
    entries = [e for e in spans if e["name"] == "tfft.entry"]
    dispatches = [e for e in spans if e["name"] == "tfft.dispatch"]
    assert len(entries) == len(dispatches) == 4   # two active steps, two calls each
    for entry in entries:
        assert sum(_holds(entry, d) for d in dispatches) == 1


def test_launch_names_its_span_after_the_symbol(monkeypatch):
    """``launch`` on a stubbed library: the span is
    ``tfft.launch.<symbol without tfft_>``, the call made inside it."""
    called = []

    def four_step_col(*args):
        called.append(torch.autograd._profiler_enabled())
        return 0

    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        tfft_four_step_col=four_step_col))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    t = torch.zeros(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fused_cuda.launch("tfft_four_step_col", (t, t), (1, 1), 2, 3)
    names = [e.name for e in prof.events()]
    assert "tfft.launch.four_step_col" in names
    assert called == [True]


def test_counters_count_a_table_build_once():
    """A new key of ``mma_tables`` builds it and its fp32 ``kernel_tables``;
    the same key again builds nothing."""
    args = ((8, 4), (0.3125, 0.5), -1, "bf16", "default", torch.device("cpu"))
    before = tracing.counters()["table_builds"]
    first = fused_cuda.mma_tables(*args)
    middle = tracing.counters()["table_builds"]
    again = fused_cuda.mma_tables(*args)
    after = tracing.counters()["table_builds"]
    assert again is first
    assert middle["mma_tables"] - before["mma_tables"] == 1
    assert middle["kernel_tables"] - before["kernel_tables"] == 1
    assert after == middle


def test_counted_launchers_are_the_library_s():
    """Every launcher counted is a C launcher of the library, every C
    launcher is counted, and a count is its wrapper's ``launches``."""
    launches = tracing.counters()["launches"]
    assert {f"tfft_{s}" for s in launches} <= set(_build._SIGNATURES)
    assert launches["fused_fft"] == fused_cuda.fused_fft.launches
    assert set(_build._SIGNATURES) - {f"tfft_{s}" for s in launches} == set()


def test_counters_report_variants(monkeypatch):
    """``variants`` holds each counted wrapper's launches per variant; a
    launch of kernel A's pipelined kernel on tiles of 16 rows (the rule at
    512 x (132 * 16 + 1) on a
    card of 132 SMs, the C launch recorded) counts under
    ``pipelined,tile16,mma``."""
    counted = tracing.counters()
    assert counted["variants"]["fused_fft"] == dict(fused_cuda.fused_fft.variant_launches)
    assert set(counted["variants"]) <= set(counted["launches"])
    for symbol, per_variant in counted["variants"].items():
        assert sum(per_variant.values()) <= counted["launches"][symbol]
    monkeypatch.setattr(fused_cuda, "launch", lambda *args: None)
    monkeypatch.setattr(fused_cuda, "multiprocessors", lambda device: 132)
    # The fake launch counts on copies, so the process's counts are as
    # they were after the test.
    monkeypatch.setattr(fused_cuda.fused_fft, "launches", fused_cuda.fused_fft.launches)
    monkeypatch.setattr(fused_cuda.fused_fft, "variant_launches",
                        collections.Counter(fused_cuda.fused_fft.variant_launches))
    re = torch.zeros(132 * 16 + 1, 512, dtype=torch.bfloat16)
    before = tracing.counters()["variants"]["fused_fft"]
    fused_cuda._launch_fused(
        re, re, radices=(16, 32), scales=(1 / 16, 1 / 32), sign=-1,
        algorithm="bf16", first_dot="bf16ax2", engine="stacked", grouped=False,
        complex_mult="block", state_dtype="float32")
    after = tracing.counters()["variants"]["fused_fft"]
    assert {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)} == {"pipelined,tile16,mma": 1}
