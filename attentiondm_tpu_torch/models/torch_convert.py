"""The reference's torch DDIM state dict -> the port's param tree (port of
`attentiondm_tpu/models/torch_convert.py`).

The published checkpoints (`model-790000.ckpt` ...) are state dicts of the
original DDIM torch model, with keys such as `temb.dense.0.weight`,
`conv_in.weight` [C_out, C_in, kH, kW], `down.0.attn.0.q.weight`,
`mid.block_1.temb_proj.bias` and `norm_out.weight`.  The mapping is by
name, strict both ways (every unmapped and every missing key is named), with
the layout transposes conv OIHW -> HWIO and dense [out, in] -> [in, out].
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .. import default_device
from .unet import UNetConfig, unet_init

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
    else:
        yield path


def params_to_torch_names(cfg: UNetConfig, like=None) -> Dict[str, tuple]:
    """{torch state-dict key: the leaf's path in the param tree} (of `like`,
    a param tree of `cfg`, where the caller has one)."""
    out = {}
    for path in _paths(unet_init(torch.Generator().manual_seed(0), cfg, "cpu") if like is None else like):
        stem = []
        for p in path[:-1]:
            stem += ["dense", p[-1]] if p in ("dense0", "dense1") else [p]
        out[".".join(stem + [_LEAF[path[-1]]])] = path
    return out


def convert_ddim_state_dict(state_dict: Mapping, cfg: UNetConfig, device=None):
    """The param tree of a torch DDIM state dict (tensors or arrays), float32
    on `device` (None: the package's `default_device()`).  Raises KeyError
    naming the unmapped and the missing keys, ValueError on a shape that
    does not fit."""
    device = default_device() if device is None else device
    params = unet_init(torch.Generator().manual_seed(0), cfg, "cpu")
    name_map = params_to_torch_names(cfg, params)
    unmapped = [k for k in state_dict if k not in name_map]
    missing = [k for k in name_map if k not in state_dict]
    if unmapped or missing:
        raise KeyError(f"checkpoint/model name mismatch; unmapped ckpt keys: {unmapped[:10]} "
                       f"(+{max(0, len(unmapped) - 10)} more); missing from ckpt: {missing[:10]} "
                       f"(+{max(0, len(missing) - 10)} more)")
    for tkey, path in name_map.items():
        v = state_dict[tkey]
        arr = torch.as_tensor(v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
        if path[-1] == "kernel":
            arr = arr.permute(2, 3, 1, 0) if arr.ndim == 4 else arr.t()
        node = params
        for p in path[:-1]:
            node = node[int(p)] if isinstance(node, list) else node[p]
        if tuple(arr.shape) != tuple(node[path[-1]].shape):
            raise ValueError(f"shape mismatch for {tkey} -> {'/'.join(path)}: {tuple(arr.shape)} vs "
                             f"{tuple(node[path[-1]].shape)}")
        node[path[-1]] = arr.to(torch.float32).contiguous().to(device)
    return params


def ddim_state_dict(params, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """The reference-named torch state dict of a param tree (the inverse of
    `convert_ddim_state_dict`: HWIO -> OIHW, [in, out] -> [out, in]), on the CPU."""
    out = {}
    for tkey, path in params_to_torch_names(cfg, params).items():
        node = params
        for p in path:
            node = node[int(p)] if isinstance(node, list) else node[p]
        a = node.detach().cpu()
        if path[-1] == "kernel":
            a = a.permute(3, 2, 0, 1) if a.ndim == 4 else a.t()
        out[tkey] = a.contiguous()
    return out


def load_torch_checkpoint(path: str, cfg: UNetConfig, ema: bool = False, device=None):
    """Load a `.ckpt` / `.pth` file saved by torch and convert it.

    Takes a bare state dict or the reference's training-states list
    `[model, optim, epoch, step, (ema)]`; `ema=True` takes its last entry.
    DataParallel `module.` prefixes are stripped.  The file is read with
    `weights_only=True` (tensors and plain containers, no pickled code)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, (list, tuple)):
        obj = obj[-1] if ema else obj[0]
    if not isinstance(obj, Mapping):
        raise TypeError(f"unsupported checkpoint object: {type(obj)}")
    obj = {(k[7:] if k.startswith("module.") else k): v for k, v in obj.items()}
    return convert_ddim_state_dict(obj, cfg, device=device)
