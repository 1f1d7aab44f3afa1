"""Everything a run needs, found by name: the cell in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its correctness limits (`workloads/<cell>.json`)
and a reader per metric (`metrics/<metric>.py`).  A cell, a configuration, a
mix or a metric is added by adding files and `BENCHMARK.json` entries."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json and the program beside portbench/


def _load(path: Path, what: str) -> dict:
    if not path.is_file():
        raise LookupError(f"no {what} at {path}")
    with open(path) as f:
        return json.load(f)


class Registry:
    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.bench = _load(self.root / "BENCHMARK.json", "BENCHMARK.json")
        self.dir = self.root / "portbench"

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.bench["workloads"])
        raise LookupError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def config(self, name: str) -> dict:
        return _load(self.dir / "configs" / f"{name}.json", f"configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return _load(self.dir / "traffic" / f"{name}.json", f"traffic mix {name!r}")

    def limits(self, cell: str) -> dict:
        return _load(self.dir / "workloads" / f"{cell}.json", f"correctness limits of {cell!r}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` prints: the end-to-end ones at
        trace 0, the per-layer ones at trace 1, each where its `workloads`
        list names the cell or it has none."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """`read(record)` of `metrics/<metric>.py`."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise LookupError(f"no reader for metric {metric!r} at {path}")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def roofline(self, config: dict):
        """The operations and bytes of the configuration's kernels,
        `roofline/<name>.py` (its `step_work(cfg, batch, ...)`)."""
        return importlib.import_module(f"portbench.roofline.{config['roofline']}")

    def reference(self, config: dict):
        """The configuration's plain reference, `reference/<name>.py`."""
        return importlib.import_module(f"portbench.reference.{config['reference']}")
