"""Readings that the limits of ``correct`` are set from, for one cell, in one
process on the card:

* the program over many seeds (the lower readings: the largest of each
  number);
* each control over a few seeds (the upper readings: the smallest): the
  reference put in the program's place in a precision below the
  configuration's (``references/<entry>.py:CONTROLS``), run through the
  same window, sample and comparison.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 101,102,103 --seconds 2 [--out readings.json]

A limit goes above the lower reading and below the smallest upper one, with
more room above the lower (``README.md``).  Each run's numbers are printed as it ends.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)


def control_calls(control, config, dtype):
    return {d: functools.partial(control, direction=d,
                                 scaling=config["scaling"], out_dtype=dtype)
            for d in ("forward", "inverse")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from portbench import harness, spec, traffic

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    reference = spec.load_module("references", cell.entry)
    dtype = traffic.DTYPES[cell.config["precision"]]
    sides = [("program", args.seeds, None)] + [
        (name, args.control_seeds,
         functools.partial(control_calls, control, dtype=dtype))
        for name, control in reference.CONTROLS.items()]
    readings = {"workload": cell.name, **{side: {} for side, _, _ in sides}}
    for side, seeds, make_calls in sides:
        for seed in (int(s) for s in seeds.split(",")):
            t0 = time.perf_counter()
            result = harness.run(cell, seed, args.seconds, False, device, t0,
                                 make_calls=make_calls)
            numbers = {k: c["value"] for k, c in result["checks"].items()}
            readings[side][seed] = numbers
            print(f"{side} seed {seed}: correct {result['correct']} "
                  f"steps {result['steps']} {json.dumps(numbers)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            torch.cuda.empty_cache()
    names = sorted(next(iter(readings["program"].values())))
    summary = {}
    for name in names:
        lower = max(r[name] for r in readings["program"].values())
        upper = {side: min(r[name] for r in readings[side].values())
                 for side, _, _ in sides[1:]}
        summary[name] = {"lower": lower, "upper": upper, "limit": cell.limits[name]}
        print(f"{name}: lower {lower!r} upper " + ", ".join(
            f"{side} {u!r} ({u / lower:.2f}x)" for side, u in upper.items())
              + f"; limit {cell.limits[name]!r}")
    readings["summary"] = summary
    readings["card"] = harness.card(device)
    print(f"card: {readings['card']}; {time.perf_counter() - T_START:.1f} s in all")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
