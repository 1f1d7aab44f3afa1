"""Calibration-state persistence (port of `attentiondm_tpu/quant/calib_cache.py`).

One self-describing compressed `.npz` holds what calibration produces:

  - per-layer ActQuantState fields (`qstate/<layer>/<field>`),
  - per-step attention q/k/v absmax ranges (`attn/<projection>`),
  - per-layer WeightExtras (`extras/<layer>/<field>`: signed int16 rounding
    offsets, bias-correction mu, pinned shrink, per-step out_mult /
    bias_delta),
  - the 'diff' t-mode bookkeeping (`misc/sample_count`,
    `misc/timestep_select`),
  - a JSON header (`meta`: seq, bit policy, attention variant ...) that must
    match the requesting run; a cache that does not match is ignored.

Format 3, the keys and the header are JAX's, so a cache written by either
package loads in the other.  `args` is any object with the runner's
attribute names.
"""
from __future__ import annotations

import json
import logging
import os
import zipfile
from typing import Dict

import numpy as np
import torch

from .. import default_device
from .adaround import WeightExtras
from .state import ActQuantState

_QFIELDS = ("init_range", "act_min", "act_max", "group_ranges", "alpha_logits")
_XFIELDS = ("round_offset", "mu", "shrink", "out_mult", "bias_delta")
# 3: round_offset int16 (GPTQ offsets are signed and multi-level; format 2's
#    uint8 stored negatives as 255) and the per-step refinements persist
_FORMAT = 3


def _meta_of(args, seq, model_sig=None) -> dict:
    return {
        "format": _FORMAT,
        "seq": [int(s) for s in seq],
        "seed": int(getattr(args, "seed", 0)),
        "eta": float(getattr(args, "eta", 0.0)),
        "bitwidth": int(getattr(args, "bitwidth", 8)),
        "a_bitwidth": getattr(args, "a_bitwidth", None),
        "normgroup": int(getattr(args, "normgroup", 0) or 0),
        "attn_variant": getattr(args, "attn_variant", "ddim"),
        "calibrate_attention": bool(getattr(args, "calibrate_attention", False)),
        "calib_t_mode": getattr(args, "calib_t_mode", "real"),
        "weight_opt": getattr(args, "weight_opt", "adaround"),
        "weight_refine": getattr(args, "weight_refine", "off") or "off",
        "stage2_mode": getattr(args, "stage2_mode", "reference"),
        # a cache without attention ranges must not serve an --attn_int8 run
        "attn_int8": bool(getattr(args, "attn_int8", False)),
        # shared-fold extras sit on the rank-1 u grid: they must not serve a per-step fold, and vice versa
        "shared_fold": bool(getattr(args, "shared_fold", False)),
        "model": model_sig,
    }


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_calibration(path: str, args, seq, qstates: Dict[str, ActQuantState], *, attn_ranges=None,
                     weight_extras=None, sample_count=None, timestep_select=None, model_sig=None) -> None:
    flat: Dict[str, np.ndarray] = {}
    for name, st in qstates.items():
        for f in _QFIELDS:
            flat[f"qstate/{name}/{f}"] = _np(getattr(st, f))
    if attn_ranges:
        for name, arr in attn_ranges.items():
            flat[f"attn/{name}"] = _np(arr)
    if weight_extras:
        for name, ex in weight_extras.items():
            for f in _XFIELDS:
                v = getattr(ex, f)
                if v is None:
                    continue
                v = _np(v)
                flat[f"extras/{name}/{f}"] = v.astype(np.int16) if f == "round_offset" else v
    if sample_count is not None:
        flat["misc/sample_count"] = _np(sample_count)
    if timestep_select is not None:
        flat["misc/timestep_select"] = np.asarray(int(timestep_select))
    flat["meta"] = np.frombuffer(json.dumps(_meta_of(args, seq, model_sig)).encode(), dtype=np.uint8)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)
    logging.info(f"saved calibration cache to {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


def load_calibration(path: str, args, seq, model_sig=None, device=None):
    """The cache at `path` if it exists and its header matches the requesting
    configuration, as a dict with keys qstates, attn_ranges, weight_extras,
    sample_count and timestep_select (tensors on `device`; None: the
    package's `default_device()`; round offsets int16); else None."""
    if not path or not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:  # a corrupt cache: recalibrate, don't crash the run
        logging.warning(f"ignoring unreadable calibration cache {path}: {e}")
        return None
    try:
        meta = json.loads(bytes(flat.pop("meta").tobytes()).decode())
    except (KeyError, ValueError):
        logging.warning(f"ignoring calibration cache {path}: missing/invalid meta")
        return None
    want = _meta_of(args, seq, model_sig)
    if meta != want:
        diff = {k: (meta.get(k), want[k]) for k in want if meta.get(k) != want[k]}
        logging.warning(f"ignoring calibration cache {path}: config mismatch {diff}")
        return None

    device = default_device() if device is None else device

    def tensor(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    qstates: Dict[str, dict] = {}
    attn_ranges: Dict[str, torch.Tensor] = {}
    extras: Dict[str, dict] = {}
    out = {"sample_count": None, "timestep_select": None}
    for k, v in flat.items():
        parts = k.split("/")  # layer names hold dots, not slashes
        if parts[0] == "qstate":
            qstates.setdefault("/".join(parts[1:-1]), {})[parts[-1]] = tensor(v)
        elif parts[0] == "attn":
            attn_ranges["/".join(parts[1:])] = tensor(v)
        elif parts[0] == "extras":
            extras.setdefault("/".join(parts[1:-1]), {})[parts[-1]] = tensor(
                v.astype(np.int16) if parts[-1] == "round_offset" else v)
        elif k == "misc/sample_count":
            out["sample_count"] = tensor(v)
        elif k == "misc/timestep_select":
            out["timestep_select"] = int(v)
    out["qstates"] = {n: ActQuantState(**{f: d[f] for f in _QFIELDS}) for n, d in qstates.items()}
    out["attn_ranges"] = attn_ranges or None
    out["weight_extras"] = {n: WeightExtras(**{f: d.get(f) for f in _XFIELDS}) for n, d in extras.items()} or None
    logging.info(f"loaded calibration cache from {path} ({len(out['qstates'])} layers)")
    return out
