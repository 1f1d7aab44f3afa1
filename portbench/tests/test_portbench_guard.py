"""No module of JAX or of the JAX package is loaded by a run, compared by
whole top-level name; the reference imports nothing of the port."""
import ast
import subprocess
import sys
import types

from portbench.harness import runner

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "attentiondm_tpu"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "attentiondm_tpu_torch_fake", types.ModuleType("attentiondm_tpu_torch_fake"))
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in runner.forbidden_modules() and "attentiondm_tpu_torch_fake" not in before


def test_a_run_loads_no_jax():
    """Import everything run.py imports and drive a toy run on the CPU in a
    fresh process; then no loaded module's top-level name is forbidden."""
    code = (
        "import sys, time, runpy, pathlib, tempfile, shutil\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "runpy.run_path('portbench/run.py', run_name='not_main')\n"
        "from portbench.tests.conftest import add_toy\n"
        "from portbench.harness.registry import Registry\n"
        "from portbench.harness.runner import execute\n"
        "import torch; torch.set_num_threads(2)\n"
        "d = pathlib.Path(tempfile.mkdtemp())\n"
        f"shutil.copy({str(ROOT / 'BENCHMARK.json')!r}, d / 'BENCHMARK.json')\n"
        f"shutil.copytree({str(ROOT / 'portbench')!r}, d / 'portbench')\n"
        "cell = add_toy(d)\n"
        "r = execute(Registry(d), cell, 5, 0.1, False, 'cpu', time.perf_counter())\n"
        "shutil.rmtree(d)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "attentiondm_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module


def test_sources_import_no_jax_and_the_reference_none_of_the_port():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "reference" in path.parts:
            assert "attentiondm_tpu_torch" not in tops, path
