"""Config files: YAML -> nested namespace (port of `attentiondm_tpu/config.py`).

The same YAML schema as the JAX package's configs (data / model / diffusion
/ training / sampling / optim groups).  A bare file name resolves against
the package's own copies, `attentiondm_tpu_torch/configs/` (byte-equal to
the JAX package's, so the port runs on a tree that ships it alone).
"""
from __future__ import annotations

import argparse
import os

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def dict2namespace(config: dict) -> argparse.Namespace:
    namespace = argparse.Namespace()
    for key, value in config.items():
        if isinstance(value, dict):
            value = dict2namespace(value)
        setattr(namespace, key, value)
    return namespace


def namespace2dict(ns) -> dict:
    out = {}
    for k, v in vars(ns).items():
        out[k] = namespace2dict(v) if isinstance(v, argparse.Namespace) else v
    return out


def load_config(path: str) -> argparse.Namespace:
    """Load a YAML config; bare names resolve against CONFIG_DIR."""
    import yaml

    if not os.path.exists(path):
        candidate = os.path.join(CONFIG_DIR, path)
        if os.path.exists(candidate):
            path = candidate
    with open(path) as f:
        return dict2namespace(yaml.safe_load(f))
