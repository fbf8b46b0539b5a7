"""Result/benchmark/accuracy file writers.

Mirror of the reference FileWriter.h: result dumps as ``x RE IM`` lines
(:19-169), accuracy tables (``Accuracy_Test.dat``, :206-225), benchmark tables
(``BenchResults.dat``, :271-310), tuner tables (:227-248) and a log writer
(:192-203), in the JAX package's text formats byte for byte, plus JSON
variants for tooling.  Tensors passed in are moved to the host here (bf16
through float32, which holds it exactly).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tensorfft_tpu_torch.testing.metrics import deviation

__all__ = [
    "write_results_to_file",
    "read_results_from_file",
    "write_result_batch_to_files",
    "read_result_batch_from_files",
    "compare_result_files",
    "compare_many_result_files",
    "write_accuracy_table",
    "write_bench_table",
    "write_tuner_data",
    "write_log",
]


def _host(x) -> np.ndarray:
    """A host numpy array of ``x``; a bf16 tensor comes back as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def write_results_to_file(path, re, im):
    """``x RE IM`` per line (FileWriter.h:19-76 analog), split planar input."""
    re = _host(re).ravel()
    im = _host(im).ravel()
    with open(path, "w") as f:
        for x in range(len(re)):
            f.write(f"{x} {re[x]:.17g} {im[x]:.17g}\n")


def read_results_from_file(path):
    """Parse an ``x RE IM`` file back to split planar arrays
    (AccuracyCalculator.h:150-658 file-comparison analog)."""
    xs, res, ims = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            xs.append(int(parts[0]))
            res.append(float(parts[1]))
            ims.append(float(parts[2]))
    order = np.argsort(xs)
    return np.asarray(res)[order], np.asarray(ims)[order]


def write_result_batch_to_files(prefix, re, im):
    """One ``x RE IM`` file per batch element (FileWriter.h:78-169 analog).

    ``re``/``im`` are (batch, n) planes; files are ``<prefix>_<i>.dat``.
    Returns the list of paths written.
    """
    re = _host(re)
    im = _host(im)
    if re.ndim == 1:
        re = re[None]
        im = im[None]
    paths = []
    for i in range(re.shape[0]):
        p = f"{prefix}_{i}.dat"
        write_results_to_file(p, re[i], im[i])
        paths.append(p)
    return paths


def read_result_batch_from_files(paths):
    """Stack per-element result files back into (batch, n) planes."""
    res, ims = [], []
    for p in paths:
        r, i = read_results_from_file(p)
        res.append(r)
        ims.append(i)
    return np.stack(res), np.stack(ims)


def compare_result_files(path_a, path_b):
    """Deviation between two ``x RE IM`` files
    (AccuracyCalculator.h:150-346 file-based comparison analog).

    Returns a testing.metrics.Deviation over the complex difference.
    """
    a = read_results_from_file(path_a)
    b = read_results_from_file(path_b)
    if a[0].shape != b[0].shape:
        raise ValueError(
            f"length mismatch: {a[0].shape} vs {b[0].shape} "
            f"({path_a} vs {path_b})"
        )
    return deviation(a, b)


def compare_many_result_files(paths, reference_path):
    """Many-vs-one file comparison (AccuracyCalculator.h:349-658 analog).

    The reference harness compares each batch element's dump against one
    oracle dump; returns the list of per-file Deviations in input order.
    """
    return [compare_result_files(p, reference_path) for p in paths]


def write_accuracy_table(path, rows: Sequence[dict]):
    """Accuracy table (Accuracy_Test.dat analog, FileWriter.h:206-225).

    rows: dicts with fft_length/avg/sigma/max (extra keys land in the JSON
    sidecar).
    """
    with open(path, "w") as f:
        f.write("# fft_length avg_deviation sigma_deviation max_deviation\n")
        for r in rows:
            f.write(
                f"{r['fft_length']} {r['avg']:.8e} {r['sigma']:.8e} {r['max']:.8e}\n"
            )
    Path(str(path) + ".json").write_text(json.dumps(list(rows), indent=1))


def write_bench_table(path, rows: Sequence[dict]):
    """Benchmark table (BenchResults.dat analog, FileWriter.h:271-310)."""
    with open(path, "w") as f:
        f.write("# fft_length batch avg_time_us sigma_us gflops\n")
        for r in rows:
            f.write(
                f"{r['fft_length']} {r.get('batch', 1)} "
                f"{r['avg_time_us']:.3f} {r.get('sigma_us', 0.0):.3f} "
                f"{r.get('gflops', 0.0):.1f}\n"
            )
    Path(str(path) + ".json").write_text(json.dumps(list(rows), indent=1))


def write_tuner_data(n, batch, precision, audit, winner_tuning, dump_dir,
                     tag=""):
    """Full per-config tuner measurement table (TunerData_<N>.dat analog,
    FileWriter.h:227-248).

    ``audit`` rows are (config, time_ns, sigma_ns, phase) in measurement
    order — the whole sweep plus every head-to-head arm and the incumbent
    guard — so the winning cache entry is auditable after the fact; a
    config is a tuning dict or an object with ``as_tuning()``.  Writes ``tuner_data_<n><tag>.dat`` (+ JSON sidecar) in
    ``dump_dir``; returns the path.  ``tag`` keeps challenge-only retune
    dumps (a handful of twin rows) from clobbering a full structural-sweep
    table at the same length.
    """
    dump_dir = Path(dump_dir)
    dump_dir.mkdir(parents=True, exist_ok=True)
    path = dump_dir / f"tuner_data_{n}{tag}.dat"
    rows = []
    for cfg, t_ns, s_ns, phase in audit:
        tuning = cfg.as_tuning() if hasattr(cfg, "as_tuning") else dict(cfg)
        rows.append({
            "config": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in tuning.items()},
            "time_us": None if not np.isfinite(t_ns) else round(t_ns / 1e3, 2),
            "sigma_us": round(s_ns / 1e3, 2),
            "phase": phase,
        })
    meta = {
        "fft_length": n, "batch": batch, "precision": precision,
        "winner": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in winner_tuning.items()},
        "rows": rows,
    }
    with open(path, "w") as f:
        f.write("# phase time_us sigma_us config\n")
        for r in rows:
            t = "inf" if r["time_us"] is None else f"{r['time_us']:.2f}"
            f.write(f"{r['phase']} {t} {r['sigma_us']:.2f} "
                    f"{json.dumps(r['config'], sort_keys=True)}\n")
        f.write(f"# winner {json.dumps(meta['winner'], sort_keys=True)}\n")
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=1))
    return path


def write_log(path, messages: Sequence[str]):
    """Append log lines (FileWriter.h:192-203 analog)."""
    with open(path, "a") as f:
        for m in messages:
            f.write(m.rstrip("\n") + "\n")
