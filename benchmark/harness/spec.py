"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration's file, its traffic mix (``benchmark/traffic/<name>.json``),
its correctness limits (``benchmark/limits/<cell>.json``), its driver
(``benchmark/drivers/<name>.py``) and a reader per metric
(``benchmark/metrics/<name>.py``).  A later cell, mix, configuration or
metric is a new file and a new entry; nothing here changes."""
from __future__ import annotations

import importlib
import json
import os
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def module_name(name: str) -> str:
    """A metric's or driver's module name: its name with '.' and '-' as
    '_'."""
    return name.replace(".", "_").replace("-", "_")


class Cell:
    """One cell of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, man: Dict = None):
        man = manifest() if man is None else man
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                           f"{', '.join(sorted(cells))})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in man["configs"]}[self.entry["config"]]
        self.config = _json(os.path.join(ROOT, conf["file"]))
        self.traffic = _json(os.path.join(BENCH, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(BENCH, "limits", name + ".json"))
        self.end_to_end = self._metrics(man["end_to_end"])
        self.per_layer = self._metrics(man["per_layer"])

    def _metrics(self, entries: List[Dict]) -> List[Dict]:
        return [m for m in entries
                if self.name in m.get("workloads", [self.name])]

    def driver(self):
        return importlib.import_module(
            "benchmark.drivers." + module_name(self.config["driver"]))


def reader(name: str):
    """The module that reads metric ``name``: ``read(ctx) -> float or
    None`` and ``ACROSS`` (how ranks' readings combine: "mean", "max" or
    "min")."""
    return importlib.import_module("benchmark.metrics." + module_name(name))
