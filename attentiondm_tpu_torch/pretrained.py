"""The published DDIM checkpoints by name (port of `attentiondm_tpu/pretrained.py`).

The registry's names, relative paths and md5s are JAX's.  A checkpoint is
looked up under `root`, then `$ATTENTIONDM_CKPT_ROOT`, then
`~/.cache/attentiondm`, and md5-verified with `check=True`.  Nothing is
downloaded: a checkpoint that is not there raises FileNotFoundError naming
the path to place it at and its md5.  The files load through
`models.torch_convert.load_torch_checkpoint`.
"""
from __future__ import annotations

import hashlib
import os

CKPT_MAP = {
    "cifar10": "diffusion_cifar10_model/model-790000.ckpt",
    "ema_cifar10": "ema_diffusion_cifar10_model/model-790000.ckpt",
    "lsun_bedroom": "diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "ema_lsun_bedroom": "ema_diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "lsun_cat": "diffusion_lsun_cat_model/model-1761000.ckpt",
    "ema_lsun_cat": "ema_diffusion_lsun_cat_model/model-1761000.ckpt",
    "lsun_church": "diffusion_lsun_church_model/model-4432000.ckpt",
    "ema_lsun_church": "ema_diffusion_lsun_church_model/model-4432000.ckpt",
}
MD5_MAP = {
    "cifar10": "82ed3067fd1002f5cf4c339fb80c4669",
    "ema_cifar10": "1fa350b952534ae442b1d5235cce5cd3",
    "lsun_bedroom": "f70280ac0e08b8e696f42cb8e948ff1c",
    "ema_lsun_bedroom": "1921fa46b66a3665e450e42f36c2720f",
    "lsun_cat": "bbee0e7c3d7abfb6e2539eaf2fb9987b",
    "ema_lsun_cat": "646f23f4821f2459b8bafc57fd824558",
    "lsun_church": "eb619b8a5ab95ef80f94ce8a5488dae3",
    "ema_lsun_church": "fdc68a23938c2397caba4a260bc2445f",
}


def md5_hash(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ckpt_roots(root: str | None = None) -> list:
    """The directories searched, in order."""
    roots = [root, os.environ.get("ATTENTIONDM_CKPT_ROOT"), os.path.expanduser("~/.cache/attentiondm")]
    return [r for r in roots if r]


def get_ckpt_path(name: str, root: str | None = None, check: bool = False) -> str:
    """The path of the registered checkpoint `name`, md5-verified with
    `check` (ValueError on a mismatch); FileNotFoundError where no searched
    directory holds it."""
    if name not in CKPT_MAP:
        raise KeyError(f"unknown checkpoint '{name}'; known: {sorted(CKPT_MAP)}")
    for r in ckpt_roots(root):
        path = os.path.join(r, CKPT_MAP[name])
        if os.path.exists(path):
            if check and md5_hash(path) != MD5_MAP[name]:
                raise ValueError(f"md5 mismatch for {path} (expected {MD5_MAP[name]})")
            return path
    where = os.path.join(ckpt_roots(root)[0], CKPT_MAP[name])
    raise FileNotFoundError(f"checkpoint '{name}' not found under {ckpt_roots(root)}; nothing is downloaded: "
                            f"place the file at {where} (md5 {MD5_MAP[name]}) or set $ATTENTIONDM_CKPT_ROOT")
