"""Checkpoint save / load of param trees (port of `attentiondm_tpu/checkpoint.py`).

JAX's name-keyed, self-describing format: one numpy `.npz` whose keys are
the flattened tree paths joined by "/", with three markers: `<path>/__len__`
(a list's length), `<path>/__none__` (a None leaf) and `<path>/__dc__` (a
dataclass: its module and qualified name as bytes).  A file written by
either package loads in the other, training states (`training.TrainState`
with optax-shaped optimizer states) among them.  For the published torch DDIM
checkpoints use `models.torch_convert.load_torch_checkpoint`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import default_device


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _flatten(tree) -> dict:
    flat = {}

    def walk(node, path):
        key = "/".join(path)
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            flat[key + "/__len__"] = np.asarray(len(node))
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif node is None:
            flat[key + "/__none__"] = np.asarray(0)
        elif hasattr(node, "__dataclass_fields__"):
            flat[key + "/__dc__"] = np.frombuffer(
                f"{type(node).__module__}|{type(node).__qualname__}".encode(), dtype=np.uint8)
            for f in node.__dataclass_fields__:
                walk(getattr(node, f), path + [f])
        else:
            flat[key] = _np(node)

    walk(tree, [])
    return flat


def save_checkpoint(path: str, tree) -> None:
    """Write `tree` (dicts, lists, tuples, dataclasses, None and tensor /
    array leaves) to `path`, through a temporary file renamed into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def read_flat(path: str) -> dict:
    """The file's {key: array}."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_checkpoint(path: str, like, *, prefix: str = "", device=None, flat: dict | None = None):
    """Fill the structure of `like` by name from the file at `path` (or its
    already read `flat` keys), under the subtree `prefix` (e.g. "ema" of a
    training state).  Leaves become tensors of the stored dtype on `device`
    (None: the package's `default_device()`); a missing key raises KeyError
    naming it."""
    device = default_device() if device is None else device
    flat = read_flat(path) if flat is None else flat

    def walk(node, path_):
        key = "/".join(path_)
        if isinstance(node, dict):
            return {k: walk(v, path_ + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if key + "/__len__" not in flat:
                raise KeyError(f"checkpoint missing key {key}/__len__")
            n = int(flat[key + "/__len__"])
            out = [walk(node[i] if i < len(node) else None, path_ + [str(i)]) for i in range(n)]
            if isinstance(node, tuple):  # a namedtuple (an optimizer state) takes its fields by position
                return type(node)(*out) if hasattr(node, "_fields") else type(node)(out)
            return out
        if node is None:
            return None
        if hasattr(node, "__dataclass_fields__"):
            return type(node)(**{f: walk(getattr(node, f), path_ + [f]) for f in node.__dataclass_fields__})
        if key not in flat:
            raise KeyError(f"checkpoint missing key {key}")
        return torch.from_numpy(np.array(flat[key], order="C")).to(device)  # np.array keeps a 0-d leaf 0-d

    return walk(like, [prefix] if prefix else [])


def load_params(path: str, like, device=None, *, ema: bool = True):
    """Model params from a `.npz` checkpoint: a bare param tree, or a
    training state's (JAX's `TrainState` keys, read by name with no
    optimizer state) `ema` subtree with `ema` (the config's `model.ema`),
    else its `params`, as JAX's `_load_params` chooses.  With `ema` a state
    saved without an EMA raises KeyError, as in JAX."""
    flat = read_flat(path)
    if any(k.startswith("params/") for k in flat):
        return load_checkpoint(path, like, prefix="ema" if ema else "params", device=device, flat=flat)
    return load_checkpoint(path, like, device=device, flat=flat)
