"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``tensorfft_tpu_torch``.  It runs on
the CUDA card(s) of the machine it is started on and exits non-zero, with no
result, without as many cards as the cell asks for.  The last line of
standard output is the result (JSON); the last lines of standard error are
the numbers that decide ``correct``, each beside its limit.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a ``torch.profiler`` trace of part of the window.

Python's compiled bytecode goes to ``.portbench_cache/pyc`` in the checkout,
so only the first run compiles torch's modules.  It exits non-zero, with no
result, when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``tensorfft_tpu`` is loaded once the window has closed (top-level module
names compared whole: ``tensorfft_tpu_torch`` is the port).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Run as a script, Python puts portbench/ itself first on the path, where its
# modules would shadow others of the same name; the checkout's root replaces it.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tensorfft_tpu")
# Compiled bytecode of every module the run imports (torch's some 2,000
# among them), kept inside the checkout at a fixed path: where the Python
# installation has none and may not write its own, each run would otherwise
# compile them all again before its first step.
PYCACHE = ROOT / ".portbench_cache" / "pyc"


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is a forbidden one."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def check_lines(result: dict):
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
            for name, c in result["checks"].items()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    import torch
    marks = [("import_torch", time.perf_counter())]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    marks.append(("cuda_driver", time.perf_counter()))

    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {cards}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START, marks=marks)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {result['card']}: "
          f"{result['steps']} steps, {result['attempted']} calls", file=sys.stderr)
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
