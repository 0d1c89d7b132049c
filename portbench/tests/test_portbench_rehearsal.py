"""A CPU rehearsal of every cell (``rehearse.py``, in a fresh process)
prints the contract's last line, and loads nothing of JAX, Flax or the JAX
package; no source of the benchmark imports them, and the reference
imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.spec import HERE, Spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pointnet12_tpu"}


@pytest.fixture(scope="module")
def rehearsal():
    out = subprocess.run([sys.executable, str(HERE / "tests" / "rehearse.py")],
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return [json.loads(line) for line in lines[:-1]], json.loads(lines[-1])


def test_every_cell_prints_the_contracts_last_line(rehearsal):
    runs, _ = rehearsal
    spec = Spec()
    assert [r["cell"] for r in runs] == [c["name"] for c in spec.bench["workloads"]]
    for i, r in enumerate(runs):
        assert r["printed"][-2].startswith("toolchain: ")
        line = json.loads(r["printed"][-1])
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert list(line)[-1] == "checks"
        assert line["attempted"] > 0 and line["failed"] == 0
        assert line["device"]["count"] == spec.cell(r["cell"])["chips"]
        for name, c in line["checks"].items():
            assert set(c) == {"value", "limit"}
        want = {m["name"] for m in spec.metrics(r["cell"], per_layer=bool(i % 2))}
        assert set(line["metrics"]) <= want
        for name, m in line["metrics"].items():
            assert m["value"] > 0 or name.startswith("feeder_wait")


def test_nothing_of_jax_is_loaded(rehearsal):
    _, loaded = rehearsal
    assert loaded == []


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_no_source_imports_jax():
    for path in HERE.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    """The reference's files, and the benchmark modules they import, name
    neither the program nor JAX (top-level names compared whole)."""
    seen, todo = set(), [p for p in (HERE / "reference").glob("*.py")]
    todo += [HERE / "weights.py", HERE / "data" / "__init__.py", HERE / "data" / "synthetic.py",
             HERE / "data" / "augment.py"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"pointnet12_tpu_torch"}, (path, name)
            if top == "portbench" and "." in name:
                rel = Path(*name.split(".")[1:])
                for cand in (HERE / rel.with_suffix(".py"), HERE / rel / "__init__.py"):
                    if cand.exists():
                        todo.append(cand)
    assert HERE / "reference" / "layers.py" in seen
