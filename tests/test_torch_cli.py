"""The port's CLI (`main_torch.py`) against `main.py`: for each argv the
parsed namespace, the config and the folders it prepares are JAX's; the CLI
and every module of the port import no JAX; a run without a CUDA device
stops with an error instead of going on on the CPU."""
import logging
import os
import subprocess
import sys

import pytest

import main_torch
from attentiondm_tpu_torch.config import namespace2dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE = ["--config", "cifar10.yml", "--doc", "cifar10", "--sample", "--execution", "serving", "--ni",
         "--batch_size", "128", "--timesteps", "10", "--skip_type", "quad"]
ARGVS = {
    "serving": SERVE,
    "fid": SERVE + ["--fid", "--num_samples", "256", "--calib_cache", "auto", "--eta", "0.5",
                    "--sample_type", "ddpm_noisy", "--image_folder", "fid"],
    "fp_bf16": ["--config", "church.yml", "--doc", "c", "--sample", "--fp32", "--compute_dtype", "bfloat16",
                "--interpolation", "--seed", "7", "--ni", "--verbose", "warning"],
    "flags": SERVE + ["--weight_opt", "adaround", "--weight_refine", "shared", "--stage2_mode", "teacher",
                      "--calibrate_attention", "--attn_variant", "enhanced", "--mixed_precision_attention",
                      "--bitwidth", "4", "--a_bitwidth", "8", "--normgroup", "4", "--step_chunk", "2",
                      "--superbatch", "256", "--shared_fold", "--pack_int4", "--attn_int8", "--ckpt_path", "m.ckpt",
                      "--use_pretrained", "--calib_t_mode", "diff", "--sequence", "--comment", "x",
                      "--adaround_iters", "10", "--stage2_lr", "0.1", "--calib_epochs", "2"],
    "test": ["--config", "celeba.yml", "--doc", "t", "--test", "--ni"],
    "train": ["--config", "cifar10.yml", "--doc", "tr", "--ni", "--exp", "exp2"],
}


@pytest.fixture
def jax_main(tmp_path, monkeypatch):
    """main.py, imported with its JAX compile cache pointed into tmp_path
    (restored after the test), and the root logger's handlers restored."""
    import jax

    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jaxcache"))
    saved_dir = jax.config.jax_compilation_cache_dir
    saved_min = jax.config.jax_persistent_cache_min_compile_time_secs
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    sys.path.insert(0, REPO)
    import main

    yield main
    jax.config.update("jax_compilation_cache_dir", saved_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved_min)
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def _parse(parse, monkeypatch, argv, cwd):
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", ["main"] + argv)
    args, config = parse()
    return vars(args), namespace2dict(config)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs + [""])


@pytest.mark.parametrize("name", list(ARGVS))
def test_parsed_like_main_py(tmp_path, monkeypatch, jax_main, name):
    """The same namespace, config and folders (the train branch's log folder
    and config.yml, the sample branch's image folder) as main.py's
    `parse_args_and_config` on the same argv, each in its own directory."""
    argv = ARGVS[name]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _parse(jax_main.parse_args_and_config, monkeypatch, argv, tmp_path / "jax")
    got = _parse(lambda: main_torch.parse_args_and_config(argv), monkeypatch, argv, tmp_path / "torch")
    assert got == want
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    if name == "train":
        cfg = os.path.join("exp2", "logs", "tr", "config.yml")
        assert open(tmp_path / "torch" / cfg).read() == open(tmp_path / "jax" / cfg).read()


@pytest.mark.parametrize("flag", ["--tp", "--sp"])
def test_parallel_degrees_raise(tmp_path, monkeypatch, flag):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        main_torch.main(SERVE + [flag, "2"])


def test_cli_imports_no_jax_and_needs_cuda(tmp_path):
    """In a fresh interpreter: main_torch and every module of the port load
    without JAX or the JAX package, and a sampling run on a machine without
    a CUDA device returns 1 after logging why (nothing goes on on the CPU)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import main_torch, attentiondm_tpu_torch\n"
        "for m in pkgutil.walk_packages(attentiondm_tpu_torch.__path__, 'attentiondm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "for m in ('eval', 'eval.fid', 'eval.inception', 'eval.clip_score', 'tools.quality_protocol',\n"
        "          'tools.real_ckpt', 'tools.train_bench'):\n"
        "    assert 'attentiondm_tpu_torch.' + m in sys.modules, m\n"
        "assert not torch.cuda.is_available()\n"
        "rc = main_torch.main(['--config', 'cifar10.yml', '--doc', 'd', '--sample', '--fp32', '--ni', '--exp', 'e'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'attentiondm_tpu'))\n"
        "print('RESULT', rc, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert "RESULT 1 []" in out.stdout, out.stdout + out.stderr
    assert "CUDA device" in out.stderr
