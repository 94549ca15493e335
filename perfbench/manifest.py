"""The benchmark's manifest and the files it names, found by name.

``BENCHMARK.json`` at the root of a checkout lists configurations, cells
(``workloads``) and metrics. A configuration's file is the path its entry
gives; a traffic mix is ``perfbench/traffic/<name>.json``; each metric's
reader is ``perfbench/metrics/<name>.py``, a module whose ``read(run)``
returns the metric's value or None where the run has nothing to read.
Adding a cell, a mix or a metric adds files and entries here and edits
no file that is already there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent


class Bench:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: Dict[str, Callable] = {}

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, as run."""
        return json.loads((self.root / self.config_entry(name)["file"])
                          .read_text())

    def mix(self, name: str) -> dict:
        """The traffic mix ``perfbench/traffic/<name>.json``."""
        return json.loads((self.root / "perfbench" / "traffic"
                           / f"{name}.json").read_text())

    def metrics(self, cell: str, per_layer: bool) -> List[dict]:
        """The end-to-end (or, with ``per_layer``, per-layer) metrics that
        ``cell`` reports: those whose ``workloads`` list it, and those
        without the key (a per-layer one then where the end-to-end metric
        it moves is reported)."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not per_layer:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ()) or (
                    "workloads" not in m and m["moves"] in moved)]

    def reader(self, name: str) -> Callable:
        """``read`` of ``perfbench/metrics/<name>.py``."""
        if name not in self._readers:
            path = self.root / "perfbench" / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{len(self._readers)}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._readers[name] = module.read
        return self._readers[name]
