"""The port's own configs and launch scripts.

`attentiondm_tpu_torch/configs/` holds byte-equal copies of the JAX
package's six YAML files, and `config.CONFIG_DIR` points there, so the port
runs on a tree that ships it without `attentiondm_tpu/`: a subprocess in a
directory holding only `attentiondm_tpu_torch/` and `main_torch.py` loads
every config by its bare name and `main_torch.py --help` exits 0.  No
string of the port's code (docstrings aside) names a path inside the JAX
package.  `sample_cifar_torch.sh` and `run_attention_ablation_torch.sh`
pass the JAX scripts' flags, which the port's parsers take.
"""
import ast
import glob
import logging
import os
import shlex
import shutil
import subprocess
import sys

import pytest

import main_torch
from attentiondm_tpu_torch import config as tconfig
from attentiondm_tpu_torch.tools import ablation_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "attentiondm_tpu", "configs")
NAMES = ("ablation_config.yml", "bedroom.yml", "celeba.yml", "church.yml", "cifar10.yml", "imagenet64.yml")
PORT_ONLY = ("adm_lsun_bedroom.yml",)  # the port's own configs, with no JAX counterpart


def test_configs_are_byte_equal_copies():
    assert sorted(os.listdir(tconfig.CONFIG_DIR)) == sorted(NAMES + PORT_ONLY)
    assert tconfig.CONFIG_DIR == os.path.join(REPO, "attentiondm_tpu_torch", "configs")
    for name in NAMES:
        with open(os.path.join(JAX_CONFIGS, name), "rb") as f, open(os.path.join(tconfig.CONFIG_DIR, name), "rb") as g:
            assert f.read() == g.read(), name


def test_the_port_runs_without_the_jax_package(tmp_path):
    """The port and main_torch.py copied alone: every config loads by its
    bare name and the CLI's --help exits 0, with nothing of the repository
    on the path."""
    shutil.copytree(os.path.join(REPO, "attentiondm_tpu_torch"), tmp_path / "attentiondm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    shutil.copy(os.path.join(REPO, "main_torch.py"), tmp_path)
    code = ("import os, sys\n"
            "from attentiondm_tpu_torch.config import CONFIG_DIR, load_config\n"
            f"assert os.path.dirname(CONFIG_DIR) == {str(tmp_path / 'attentiondm_tpu_torch')!r}, CONFIG_DIR\n"
            f"for name in {NAMES!r}:\n"
            "    cfg = load_config(name)\n"
            "    assert cfg.model.ch > 0 and cfg.data.image_size > 0, name\n"
            "assert 'attentiondm_tpu' not in sys.modules\n"
            "print('loaded', len(" + repr(NAMES) + "))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = dict(cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    p = subprocess.run([sys.executable, "-c", code], **run)
    assert p.returncode == 0 and "loaded 6" in p.stdout, p.stdout + p.stderr
    assert not os.path.exists(tmp_path / "attentiondm_tpu")
    p = subprocess.run([sys.executable, "main_torch.py", "--help"], **run)
    assert p.returncode == 0 and "--config" in p.stdout, p.stdout + p.stderr


def _docstrings(tree) -> set:
    kinds = (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    return {id(n.body[0].value) for n in ast.walk(tree) if isinstance(n, kinds) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}


def test_no_runtime_path_into_the_jax_package():
    """No string constant of the port's code, docstrings aside, names the
    JAX package (`os.path.join(..., "attentiondm_tpu", ...)` or a path
    under it); the docstrings cite JAX's lines for a reader only."""
    files = glob.glob(os.path.join(REPO, "attentiondm_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "main_torch.py"))
    assert len(files) > 50
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs \
                    and "attentiondm_tpu" in node.value.replace("attentiondm_tpu_torch", ""):
                found.append((os.path.relpath(path, REPO), node.lineno, node.value[:80]))
    assert not found, found


def _script_argv(name: str, command: str) -> list:
    """The flags a launch script passes after `command` (up to "$@")."""
    with open(os.path.join(REPO, name)) as f:
        words = shlex.split(f.read().replace("\\\n", " "), comments=True)  # the lines' continuations
    start = words.index(command) + 1
    return words[start:words.index("$@")]


@pytest.fixture
def _root_logging():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def test_sample_cifar_torch_flags_parse(tmp_path, monkeypatch, _root_logging):
    """sample_cifar_torch.sh passes sample_cifar.sh's flags to main_torch.py,
    and the port's parser takes them (no sampler runs)."""
    argv = _script_argv("sample_cifar_torch.sh", "main_torch.py")
    assert argv == _script_argv("sample_cifar.sh", "main.py")
    monkeypatch.chdir(tmp_path)
    args, config = main_torch.parse_args_and_config(argv)
    assert (args.config, args.doc, args.timesteps, args.skip_type, args.bitwidth, args.calib_t_mode) == \
        ("cifar10.yml", "cifar10_w6", 100, "quad", 6, "diff")
    assert args.sample and args.fid and args.ni and args.calibrate_attention and args.eta == 0
    assert config.data.dataset == "CIFAR10"


def test_run_attention_ablation_torch_flags_parse():
    """run_attention_ablation_torch.sh passes run_attention_ablation.sh's
    flags to the port's ablation CLI, whose parser takes them."""
    argv = _script_argv("run_attention_ablation_torch.sh", "attentiondm_tpu_torch.tools.ablation_attention")
    assert argv == _script_argv("run_attention_ablation.sh", "attentiondm_tpu.tools.ablation_attention")
    args = ablation_attention.build_parser().parse_args(argv)
    assert (args.config, args.out, args.steps, args.num_samples, args.sampler) == \
        ("cifar10.yml", "ablation_out", 50, 64, "ddpm")
    assert tconfig.load_config(args.config).model.ch == 128
