"""The harness finds configurations, traffic mixes, metrics, kernel
families and limits by name, and a new one added as files alone."""

import json
import shutil
import sys

import pytest

from portbench.spec import HERE, ROOT, Spec


@pytest.fixture
def spec():
    return Spec()


def test_every_cell_resolves(spec):
    for cell in spec.bench["workloads"]:
        cfg = spec.config(cell["config"])
        mix = spec.traffic(cell["traffic"])
        assert mix["loop"] in ("train", "serve")
        assert set(spec.limits(cell["name"])) and cfg["reduced"] == []
        per_layer = spec.metrics(cell["name"], per_layer=True)
        end_to_end = spec.metrics(cell["name"], per_layer=False)
        assert "setup_s" in {m["name"] for m in end_to_end}
        assert len(end_to_end) >= 2 and per_layer
        for m in end_to_end + per_layer:
            assert callable(spec.reader(m["name"]).read)


def test_every_metric_moves_a_metric_its_cells_report(spec):
    e2e = {m["name"]: m for m in spec.bench["end_to_end"]}
    for m in spec.bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_kernel_families(spec):
    families = spec.families()
    assert {"fps", "ballquery", "three_nn", "segment_matmul"} <= set(families)
    for family in families.values():
        assert family.KERNELS and family.CALLS and callable(family.work)


def test_a_new_cell_is_files_alone(tmp_path):
    """A configuration, a traffic mix, a metric and a kernel family added
    as new files, with entries in BENCHMARK.json, are found without an
    edit to any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    folder = root / "portbench"
    cfg = json.loads((folder / "configs" / "pointnet2_semseg-s3dis.json").read_text())
    cfg["num_point"] = 8192
    (folder / "configs" / "pointnet2_semseg-kitti.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "serve_long.json").write_text(json.dumps(
        {"loop": "serve", "requests": 4, "warmup": 1, "sample": 2, "trace_calls": 4}))
    (folder / "metrics" / "serve_p50_ms.py").write_text(
        "import statistics\n\n\ndef read(ctx):\n"
        "    return statistics.median(ctx.latencies_s) * 1e3\n")
    (folder / "kernels" / "grid_prep.py").write_text(
        "KERNELS = ('grid_prep_kernel',)\n"
        "CALLS = (('pointnet12_tpu_torch.kernels.grid_cuda', 'grid_prep_cuda'),)\n\n\n"
        "def work(args, kwargs, out):\n    return 0, 0\n")
    (folder / "limits" / "semseg-kitti.serve.json").write_text(
        json.dumps({"logprob_gap": {"limit": 1e-3}}))
    bench["configs"].append(dict(bench["configs"][0], name="pointnet2_semseg-kitti",
                                 file="portbench/configs/pointnet2_semseg-kitti.json"))
    bench["workloads"].append({"name": "semseg-kitti.serve", "config": "pointnet2_semseg-kitti",
                               "traffic": "serve_long", "chips": 1, "why": "longer scans"})
    bench["per_layer"].append({"name": "serve_p50_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "serving",
                               "moves": "serve_p95_ms", "workloads": ["semseg-kitti.serve"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("semseg-kitti.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts}

    spec = Spec(root, folder)
    assert spec.config("pointnet2_semseg-kitti")["num_point"] == 8192
    assert spec.traffic("serve_long")["requests"] == 4
    assert spec.limits("semseg-kitti.serve") == {"logprob_gap": 1e-3}
    assert [m["name"] for m in spec.metrics("semseg-kitti.serve", per_layer=True)][-1] == "serve_p50_ms"
    assert "grid_prep" in spec.families()

    class Ctx:
        latencies_s = [0.001, 0.003, 0.002]

    assert spec.read_metric("serve_p50_ms", Ctx()) == pytest.approx(2.0)
    after = {p: p.read_bytes() for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert before == after
    assert str(root) not in sys.path


def test_a_metric_of_a_pair_is_read_by_its_base_file(tmp_path):
    """``idle_share.train`` and ``idle_share.serve`` share
    ``metrics/idle_share.py``; a file of a metric's own name wins."""
    folder = tmp_path / "portbench"
    shutil.copytree(HERE, folder, ignore=shutil.ignore_patterns("__pycache__"))
    spec = Spec(ROOT, folder)
    assert spec.reader("idle_share.train").__file__ == str(folder / "metrics" / "idle_share.py")
    assert spec.reader("mfu.serve").__file__ == str(folder / "metrics" / "mfu.py")
    (folder / "metrics" / "mfu.serve.py").write_text("def read(ctx):\n    return 7\n")
    assert spec.read_metric("mfu.serve", None) == 7.0
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.train")
