"""Cells, configurations, mixes and metrics are found by name: a new one
needs new files and BENCHMARK.json entries, no edit of a file."""
import json

from portbench.harness.registry import Registry
from portbench.harness.runner import Record

from .conftest import ROOT, add_toy, write_json

CELLS = ("cifar10-w4a8-b256-ddim10", "church-w4a8-b32-ddim10")


def test_every_cell_finds_its_files():
    reg = Registry(ROOT)
    for cell in CELLS:
        w = reg.cell(cell)
        cfg = reg.config(w["config"])
        assert reg.traffic(w["traffic"])["kind"] == "closed_loop"
        assert set(reg.limits(cell)) == {"teacher_gap", "fold_gap", "block_gap", "block_median", "image_gap"}
        assert hasattr(reg.reference(cfg), "serve") and hasattr(reg.roofline(cfg), "step_work")
        for trace in (False, True):
            for m in reg.metrics(cell, trace):
                assert callable(reg.reader(m["name"]))


def test_a_new_cell_config_and_metric_need_only_new_files(bench_copy):
    before = {p: p.read_bytes() for p in (bench_copy / "portbench").rglob("*") if p.is_file()}
    cell = add_toy(bench_copy)
    (bench_copy / "portbench/metrics/calls_in_window.py").write_text(
        '"""calls_in_window: the number of calls the window completed."""\n\n\n'
        "def read(rec):\n    return len(rec.calls) or None\n")
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "Sampler loop", "moves": "images_per_s", "workloads": [cell]})
    write_json(bench_copy / "BENCHMARK.json", bench)
    after = {p: p.read_bytes() for p in (bench_copy / "portbench").rglob("*") if p.is_file() and p in before}
    assert after == before  # no file that was there changed

    reg = Registry(bench_copy)
    assert reg.config(reg.cell(cell)["config"])["data"]["image_size"] == 16
    assert reg.traffic(reg.cell(cell)["traffic"])["batch"] == 4
    names = [m["name"] for m in reg.metrics(cell, trace=True)]
    assert names == ["calls_in_window"]  # the cell is in no other per-layer metric's list
    rec = Record()
    rec.calls = [(0.0, 1.0, 4), (1.0, 2.0, 4)]
    assert reg.reader("calls_in_window")(rec) == 2
    assert [m["name"] for m in reg.metrics(cell, trace=False)] == ["images_per_s", "peak_mem_gib", "setup_s"]
    assert reg.reader("images_per_s")(rec) == 4.0


def test_benchmark_json_keeps_the_contract_shape():
    """Names, units, keys and lengths as the benchmark's contract states them."""
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["portbench"]
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"] == f"portbench/configs/{c['name']}.json"
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert name.match(w["name"]) and name.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200 and (ROOT / f"portbench/metrics/{m['name']}.py").is_file()
    assert len(json.dumps(bench)) <= 64 * 1024
