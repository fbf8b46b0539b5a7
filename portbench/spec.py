"""Finds a cell and everything it names, by name, from ``BENCHMARK.json``
and the files under ``portbench/``.

* ``portbench/cells/<workload>.json``: the configuration, the traffic, the
  entry and the limits of the numbers that decide ``correct``;
* ``portbench/configs/<config>.json`` (the file ``BENCHMARK.json`` names);
* ``portbench/traffic/<traffic>.json``;
* ``portbench/entries/<entry>.py`` (drives the program) and
  ``portbench/references/<entry>.py`` (its plain reference);
* ``portbench/metrics/<metric>.py`` for every metric the cell reports:
  with ``--trace 0`` its end-to-end metrics, with ``--trace 1`` its
  per-layer metrics (those whose ``workloads`` list it, or that have none).

Adding a cell, configuration, traffic mix, entry or metric adds files and
entries; no existing file changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: str
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = _json(HERE / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != workload[key]:
            raise ValueError(f"cell {name}: {key} {cell[key]!r} in its file, "
                             f"{workload[key]!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    return Cell(
        name=name,
        chips=int(workload["chips"]),
        config=_json(root / config_entry["file"]),
        traffic=_json(HERE / "traffic" / f"{workload['traffic']}.json"),
        entry=cell["entry"],
        limits=cell["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
