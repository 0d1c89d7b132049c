"""What the harness finds by name: the cells, metrics and configurations
of ``BENCHMARK.json``, and the files of the benchmark's own folders.

- ``configs/<config>.json``: the model configuration (``BENCHMARK.json``
  names the file);
- ``traffic/<traffic>.json``: a traffic mix, the parameters of one of the
  general loops of ``loops.py`` (its ``"loop"``);
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from;
- ``metrics/<metric>.py``: a reader, ``read(ctx) -> float or None``, of one
  metric from a run's context (``loops.Context``); a metric
  ``<base>.<part>`` without a file of its own is read by
  ``metrics/<base>.py`` (``idle_share.train`` and ``idle_share.serve`` by
  ``idle_share.py``), as ``BENCHMARK.json``'s ``workloads`` decide where
  each is reported;
- ``kernels/<family>.py``: a kernel family of the program, its device
  kernels' names, where its calls are recorded and its work counter.

A later change adds a cell, a configuration, a mix, a metric or a kernel
family by adding files and entries; nothing here changes.
"""

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` (at ``root``) and the benchmark's folders (at
    ``folder``)."""

    def __init__(self, root: Path = ROOT, folder: Path = HERE):
        self.root, self.folder = Path(root), Path(folder)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.folder / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        """``{number: limit}`` of the cell's check."""
        data = json.loads((self.folder / "limits" / f"{cell}.json").read_text())
        return {name: entry["limit"] for name, entry in data.items()}

    def metrics(self, cell: str, per_layer: bool) -> list:
        """The cell's end-to-end or per-layer metrics, in the file's order:
        those whose ``workloads`` name it, or, without ``workloads``, every
        cell (end-to-end) or every cell that reports the metric it moves
        (per-layer)."""
        if not per_layer:
            return [m for m in self.bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        reported = {m["name"] for m in self.metrics(cell, False)}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]

    def reader(self, metric: str) -> ModuleType:
        path = self.folder / "metrics" / f"{metric}.py"
        if not path.exists() and "." in metric:
            path = path.with_name(f"{metric.rsplit('.', 1)[0]}.py")
        return _load_module(path, f"portbench_metric_{metric.replace('.', '_')}")

    def families(self) -> dict:
        """``{family: module}`` of every kernel family file."""
        return {p.stem: _load_module(p, f"portbench_family_{p.stem}")
                for p in sorted((self.folder / "kernels").glob("*.py"))
                if p.stem != "__init__"}

    def read_metric(self, metric: str, ctx) -> Optional[float]:
        value = self.reader(metric).read(ctx)
        return None if value is None else float(value)
