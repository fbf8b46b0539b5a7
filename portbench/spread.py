"""Run a cell several times, each run a process of its own as a check
runs it, and print each metric's spread per set of runs.

    python3 portbench/spread.py --workload <cell> --seeds 1,2,3,4,5,6 \\
        --sets 2 --seconds 10 [--trace 0] [--out runs.jsonl]

Every set runs the same seeds in order.  A spread is (Q3 - Q1) / median,
with the quartiles of ``statistics.quantiles(values, n=4)``; beside it, the
spread left after dropping the run farthest from the median.  Each run's
result line (or the end of its standard error, when it printed none) goes to
``--out`` as one JSON line.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def trimmed_spread(values):
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return spread(rest)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--seconds", type=int, default=10)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    values = {}
    try:
        for set_index in range(args.sets):
            for seed in seeds:
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, str(RUN), "--workload", args.workload,
                     "--seed", str(seed), "--seconds", str(args.seconds),
                     "--trace", str(args.trace)],
                    capture_output=True, text=True)
                wall = time.perf_counter() - t0
                lines = proc.stdout.strip().splitlines()
                record = {"workload": args.workload, "set": set_index, "seed": seed,
                          "rc": proc.returncode, "wall_s": wall}
                if proc.returncode == 0 and lines:
                    record["result"] = json.loads(lines[-1])
                    for name, m in record["result"]["metrics"].items():
                        values.setdefault(name, {}).setdefault(set_index, []).append(m["value"])
                    summary = {k: round(m["value"], 4) for k, m in record["result"]["metrics"].items()}
                    print(f"set {set_index} seed {seed}: rc 0 correct "
                          f"{record['result']['correct']} {summary} wall {wall:.1f} s", flush=True)
                else:
                    record["stderr_tail"] = proc.stderr[-4000:]
                    print(f"set {set_index} seed {seed}: rc {proc.returncode}\n"
                          f"{proc.stderr[-2000:]}", flush=True)
                if out:
                    out.write(json.dumps(record) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    for name, sets in values.items():
        parts = []
        for set_index, vals in sorted(sets.items()):
            if len(vals) >= 3:
                parts.append(f"set {set_index}: median {statistics.median(vals)!r} "
                             f"spread {spread(vals):.5f} trimmed {trimmed_spread(vals):.5f}")
        print(f"{name}: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
