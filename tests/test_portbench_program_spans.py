"""``portbench/program_spans.py`` on synthetic chrome traces: device
operations named by the launch span that holds their launch, idle time under
the innermost span of the program, the readers' values, and the benchmark's
own readers unchanged by the program's spans."""
import collections
import json

import pytest

from portbench import harness, program_spans, spec, trace

STEPS = 20
LAT = trace.LAUNCH_LATENCY_US


def _events(program=True):
    """STEPS steps of 5000 us, 10000 us apart: ``fft_split`` [0, 200] holds
    the port's spans, then ``synchronize``; kernel B (``four_step_col``)
    starts its launch latency after its launch at 80 us and runs 1000 us,
    kernel C (``four_step_row``, launched at 130 us) right after it."""
    def x(cat, name, ts, dur, **args):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 7}
        if args:
            e["args"] = args
        return e

    events = []
    for i in range(STEPS):
        t = 10_000.0 * i
        events += [x("user_annotation", "step", t, 5000),
                   x("user_annotation", "fft_split", t, 200),
                   x("user_annotation", "synchronize", t + 200, 4800),
                   x("cuda_runtime", "cudaLaunchKernel", t + 80, 5, correlation=2 * i + 1),
                   x("cuda_runtime", "cudaLaunchKernel", t + 130, 5, correlation=2 * i + 2),
                   x("kernel", "k", t + 80 + LAT, 1000, correlation=2 * i + 1),
                   x("kernel", "k", t + 80 + LAT + 1000, 1000, correlation=2 * i + 2)]
        if program:
            events += [x("user_annotation", "tfft.entry", t + 10, 180),
                       x("cpu_op", "aten::to", t + 20, 10),
                       x("user_annotation", "tfft.dispatch", t + 40, 140),
                       x("cpu_op", "aten::empty_like", t + 50, 10),
                       x("user_annotation", "tfft.launch.four_step_col", t + 70, 30),
                       x("user_annotation", "tfft.launch.four_step_row", t + 120, 30)]
    # A cpu_op outside every program span is not kept.
    events.append(x("cpu_op", "aten::zeros", 10_000.0 * STEPS - 4000, 10))
    return events


@pytest.fixture
def paths(tmp_path):
    out = {}
    for program in (True, False):
        out[program] = str(tmp_path / f"trace_{program}.json")
        with open(out[program], "w") as f:
            json.dump({"traceEvents": _events(program)}, f)
    return out


def test_device_ops_are_named_by_their_launcher(paths):
    t = program_spans.parse(paths[True], {"fft_split": 1e-6})
    rows = dict(t.breakdown()["device_ops"])
    assert rows == pytest.approx({"four_step_col/k": STEPS * 1e-3,
                                  "four_step_row/k": STEPS * 1e-3})


def test_parse_keeps_what_trace_parse_reads(paths):
    base = trace.parse(paths[True], {"fft_split": 1e-6})
    t = program_spans.parse(paths[True], {"fft_split": 1e-6})
    assert t.window == base.window and t.spans == base.spans
    assert t.call_bounds == base.call_bounds
    assert [op[:2] for op in t.device_ops] == pytest.approx([op[:2] for op in base.device_ops])
    assert [op[2].split("/")[-1] for op in t.device_ops] == [op[2] for op in base.device_ops]
    names = collections.Counter(n for _, _, n in t.program_spans)
    assert names == {n: STEPS for n in ("tfft.entry", "aten::to", "tfft.dispatch",
                                        "aten::empty_like", "tfft.launch.four_step_col",
                                        "tfft.launch.four_step_row")}


def test_idle_lands_under_the_innermost_program_span(paths):
    t = program_spans.parse(paths[True], {"fft_split": 1e-6})
    idle = dict(t.breakdown()["idle_gaps"])
    per_step = {"fft_split": 10, "tfft.entry": 20, "aten::to": 10, "tfft.dispatch": 20,
                "aten::empty_like": 10, "tfft.launch.four_step_col": 80 + LAT - 70}
    for name, us in per_step.items():
        assert idle[name] == pytest.approx(STEPS * us * 1e-6), name
    # The step's idle is 80 + LAT before kernel B and the rest after kernel C.
    in_step = sum(v for k, v in idle.items() if k != "between_steps")
    assert in_step == pytest.approx(STEPS * (5000 - 2000) * 1e-6)
    assert idle["between_steps"] == pytest.approx((STEPS - 1) * 5000 * 1e-6)
    # The benchmark's own reduction puts all the call's idle under its span.
    base = dict(trace.parse(paths[True], {"fft_split": 1e-6}).breakdown()["idle_gaps"])
    assert base["fft_split"] == pytest.approx(STEPS * (80 + LAT) * 1e-6)


def test_equal_starts_paint_the_inner_span_last():
    """The call span and the port's entry open at the same microsecond
    inside a step that does too; the shorter one is the inner one, in
    whatever order the spans are listed."""
    spans = [(0.0, 100.0, "step"), (0.0, 50.0, "fft_split"), (0.0, 40.0, "tfft.entry"),
             (0.0, 40.0, "aten::to")]
    for order in (spans, spans[::-1]):
        idle = program_spans.idle_by_innermost((0.0, 100.0), [], order)
        inner = "aten::to" if order is spans else "tfft.entry"  # equal spans: the later
        assert idle == pytest.approx({inner: 40e-6, "fft_split": 10e-6, "step": 50e-6})


def test_readers_give_the_hand_computed_values(paths):
    t = program_spans.parse(paths[True], {"fft_split": 1e-6})
    assert program_spans.entry_ms(t) == pytest.approx((180 - 140) * 1e-3)
    assert program_spans.dispatch_ms(t) == pytest.approx((140 - 30 - 30) * 1e-3)
    assert program_spans.launch_ms(t) == pytest.approx(60 * 1e-3)
    program_idle = 20 + 10 + 20 + 10 + (80 + LAT - 70)
    idle = STEPS * (5000 - 2000) + (STEPS - 1) * 5000
    assert program_spans.idle_in_program_pct(t) == pytest.approx(
        100 * STEPS * program_idle / idle)
    before = {"table_builds": {"mma_tables": 3, "device_pq": 1}}
    after = {"table_builds": {"mma_tables": 5, "device_pq": 1}}
    assert program_spans.tables_built(before, after) == 2
    assert program_spans.tables_built(before, before) == 0


def test_readers_read_nothing_without_program_spans(paths):
    t = program_spans.parse(paths[False], {"fft_split": 1e-6})
    assert not t.program_spans
    for read in (program_spans.entry_ms, program_spans.dispatch_ms,
                 program_spans.launch_ms, program_spans.idle_in_program_pct):
        assert read(t) is None
    assert program_spans.tables_built(None, None) is None
    assert {n.split("/")[0] for _, _, n in t.device_ops} == {"k"}


@pytest.mark.parametrize("metric", ["kernels_roofline", "device_idle_pct", "enqueue_ms"])
def test_benchmark_readers_unchanged_by_program_spans(paths, metric):
    read = spec.load_module("metrics", metric).read

    def run(t):
        return harness.Run(setup_s=1.0, window_s=1.0, step_times=[5e-3] * STEPS,
                           flops=1e9, trace=t, untraced_step_times=[5.2e-3] * 4,
                           untraced_call_times=[1.5e-4] * 4)

    bounds = {"fft_split": 2e-4}
    without = read(run(trace.parse(paths[False], bounds)))
    assert without is not None
    assert read(run(trace.parse(paths[True], bounds))) == without
    assert read(run(program_spans.parse(paths[True], bounds))) == pytest.approx(without)
