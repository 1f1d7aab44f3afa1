"""Activation, weight and attention range analysis (port of
`attentiondm_tpu/tools/activation_range.py`).

Per-conv input statistics at probe timesteps (a spy `conv_apply` records
each conv's input min / max / mean / std, the std over all elements, as
JAX's `jnp.std`), per-conv weight ranges with the quartiles of each output
channel's |w| max (the Q-Diffusion-style boxplot data), and the attention
ranges: the q / k / v / output projections' inputs and, on the enhanced
variant, its logits (`attn_ctx={"collect": ...}`).  Reports are plain dicts
(`save_range_report` writes them as JSON); the plots need matplotlib, which
is imported only inside them.

    python3 -m attentiondm_tpu_torch.tools.activation_range --config cifar10.yml \\
        [--ckpt path] [--out analysis_out] [--timesteps 0,250,500,750,999] [--enhanced] [--device cpu]
    python3 -m attentiondm_tpu_torch.tools.activation_range --compare cifar10.yml,celeba.yml

It runs on the current CUDA device unless `--device` (`device=` of the
helpers: the device of `x`) names another.  The params of the CLI are a
checkpoint (`.npz`: a param tree or a training state's EMA; a torch
`.ckpt` / `.pth` by name) or seeded random ones (`unet_init` from seed 0),
its input `randn` from a generator seeded 1.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

from .. import default_device
from ..models.unet import UNetConfig, conv2d, iter_conv_layers, lookup, unet_apply, unet_init

ATTN_LEAVES = ("q", "k", "v", "proj_out", "query_conv", "key_conv", "value_conv", "output_conv")

# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------


def _probe(params, cfg: UNetConfig, x, t, spy, attn_ctx=None):
    with torch.no_grad():
        unet_apply(params, cfg, x, torch.full((x.shape[0],), float(t), device=x.device), conv_apply=spy,
                   attn_ctx=attn_ctx)


def collect_activation_ranges(params, cfg: UNetConfig, x: torch.Tensor,
                              timesteps: Sequence[int]) -> Dict[str, Dict[str, np.ndarray]]:
    """{conv: {"min", "max", "mean", "std": [len(timesteps)]}} of each
    conv's input, one forward of `x` a timestep; the convs in sorted order."""
    out: Dict[str, Dict[str, list]] = {}
    for t in timesteps:
        stats = {}

        def spy(name, xin, p, *, stride=1, padding="SAME"):
            stats[name] = torch.stack([xin.amin(), xin.amax(), xin.mean(), xin.std(correction=0)])
            return conv2d(xin, p, stride=stride, padding=padding)

        _probe(params, cfg, x, t, spy)
        for name, v in sorted(stats.items()):  # JAX's order: its stats come back as a pytree, keys sorted
            d = out.setdefault(name, {"min": [], "max": [], "mean": [], "std": []})
            for key, val in zip(("min", "max", "mean", "std"), v.tolist()):
                d[key].append(val)
    return {k: {s: np.asarray(v) for s, v in d.items()} for k, d in out.items()}


def collect_weight_ranges(params, cfg: UNetConfig) -> Dict[str, Dict[str, float]]:
    """{conv: {"min", "max", "absmax_q25", "absmax_q50", "absmax_q75",
    "absmax_max"}}: the kernel's range, and the quartiles and max of each
    output channel's |w| max."""
    out = {}
    for name, _cin, _k in iter_conv_layers(cfg):
        w = lookup(params, name)["kernel"].detach().cpu().numpy()
        per_out = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
        out[name] = {
            "min": float(w.min()),
            "max": float(w.max()),
            "absmax_q25": float(np.quantile(per_out, 0.25)),
            "absmax_q50": float(np.quantile(per_out, 0.50)),
            "absmax_q75": float(np.quantile(per_out, 0.75)),
            "absmax_max": float(per_out.max()),
        }
    return out


def collect_attention_ranges(params, cfg: UNetConfig, x: torch.Tensor,
                             timesteps: Sequence[int]) -> Dict[str, Dict[str, np.ndarray]]:
    """{site: {"min", "max": [len(timesteps)]}}: each attention projection's
    input and, on the enhanced variant, each block's logits
    (`<block>.logits`)."""
    out: Dict[str, Dict[str, list]] = {}
    for t in timesteps:
        conv_stats, attn_stats = {}, {}

        def spy(name, xin, p, *, stride=1, padding="SAME"):
            if name.rsplit(".", 1)[-1] in ATTN_LEAVES:
                conv_stats[name] = (xin.amin(), xin.amax())
            return conv2d(xin, p, stride=stride, padding=padding)

        _probe(params, cfg, x, t, spy, {"collect": attn_stats} if cfg.attn_variant == "enhanced" else None)
        logits = {f"{k}.logits": v for k, v in sorted(attn_stats.items())}
        for name, (mn, mx) in {**dict(sorted(conv_stats.items())), **logits}.items():
            d = out.setdefault(name, {"min": [], "max": []})
            d["min"].append(float(mn))
            d["max"].append(float(mx))
    return {k: {s: np.asarray(v) for s, v in d.items()} for k, d in out.items()}


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v.tolist() if isinstance(v, np.ndarray) else v


def save_range_report(report: dict, path: str) -> None:
    """`report` as JSON, arrays as lists, every dict's keys sorted (JAX's
    file: its tree_map sorts them)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(_jsonable(report), f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# plots (matplotlib, Agg backend)
# ---------------------------------------------------------------------------


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_activation_ranges(report, timesteps, out_path, max_layers=16):
    """Per-layer min / max envelopes (and the mean) over the timesteps."""
    plt = _plt()
    names = list(report)[:max_layers]
    ncol = 4
    nrow = (len(names) + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 2.5 * nrow), squeeze=False)
    for i, name in enumerate(names):
        ax = axes[i // ncol][i % ncol]
        d = report[name]
        ax.fill_between(timesteps, d["min"], d["max"], alpha=0.4)
        if "mean" in d:
            ax.plot(timesteps, d["mean"])
        ax.set_title(name, fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def plot_weight_ranges_qdiffusion_style(wreport, out_path):
    """Per-layer |w| quartile bands, median and max (log scale)."""
    plt = _plt()
    names = list(wreport)
    q25 = [wreport[n]["absmax_q25"] for n in names]
    q50 = [wreport[n]["absmax_q50"] for n in names]
    q75 = [wreport[n]["absmax_q75"] for n in names]
    mx = [wreport[n]["absmax_max"] for n in names]
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.3), 4))
    xs = np.arange(len(names))
    ax.fill_between(xs, q25, q75, alpha=0.5, label="|w| out-channel IQR")
    ax.plot(xs, q50, label="median")
    ax.plot(xs, mx, ".", label="max")
    ax.set_yscale("log")
    ax.set_xticks(xs[:: max(1, len(names) // 40)])
    ax.set_xticklabels(names[:: max(1, len(names) // 40)], rotation=90, fontsize=5)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_attention_heatmaps(report, timesteps, out_path):
    """Layer x timestep heatmap of the attention range widths."""
    plt = _plt()
    names = list(report)
    mat = np.stack([np.asarray(report[n]["max"]) - np.asarray(report[n]["min"]) for n in names])
    fig, ax = plt.subplots(figsize=(8, max(3, len(names) * 0.25)))
    im = ax.imshow(mat, aspect="auto", cmap="viridis")
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names, fontsize=5)
    ax.set_xticks(range(len(timesteps)))
    ax.set_xticklabels(timesteps, fontsize=6)
    ax.set_xlabel("timestep")
    fig.colorbar(im, ax=ax, label="range width")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def cross_model_comparison(model_reports: Dict[str, Dict[str, Dict[str, np.ndarray]]], timesteps: Sequence[int],
                           out_dir: str) -> dict:
    """Attention ranges across models: `model_reports` maps a model's name
    to its `collect_attention_ranges`.  Per model, the mean over layers of
    the output projection's input range (max - min, averaged over the
    timesteps) with its std across layers, and the per-timestep range of its
    first such layer; a bar chart, a line chart and
    `cross_model_comparison.json` under `out_dir`.  Returns the summary."""
    os.makedirs(out_dir, exist_ok=True)
    summary: dict = {"avg_output_ranges": {}, "timestep_patterns": {}}
    for model, rep in model_reports.items():
        layer_means = []
        first_pattern = None
        for name in sorted(rep):
            if not name.endswith(("proj_out", "output_conv")):
                continue
            rng = np.asarray(rep[name]["max"]) - np.asarray(rep[name]["min"])  # [T]
            layer_means.append(float(rng.mean()))
            if first_pattern is None:
                first_pattern = rng.tolist()
        if layer_means:
            summary["avg_output_ranges"][model] = {"mean": float(np.mean(layer_means)),
                                                   "std": float(np.std(layer_means))}
            summary["timestep_patterns"][model] = first_pattern

    if summary["avg_output_ranges"]:
        plt = _plt()
        models = list(summary["avg_output_ranges"])
        means = [summary["avg_output_ranges"][m]["mean"] for m in models]
        stds = [summary["avg_output_ranges"][m]["std"] for m in models]
        fig, ax = plt.subplots(figsize=(10, 6))
        xpos = np.arange(len(models))
        ax.bar(xpos, means, yerr=stds, capsize=5)
        ax.set_xticks(xpos)
        ax.set_xticklabels(models)
        ax.set_xlabel("Model")
        ax.set_ylabel("Average Output Range (Max - Min)")
        ax.set_title("Self-Attention Output Ranges Across Models")
        ax.grid(True, axis="y", linestyle="--", alpha=0.7)
        fig.savefig(os.path.join(out_dir, "model_comparison_output_ranges.png"), dpi=150)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(12, 8))
        for m, pat in summary["timestep_patterns"].items():
            if pat:
                ax.plot(list(timesteps), pat, label=m)
        ax.set_xlabel("Timestep")
        ax.set_ylabel("Output Range (Max - Min)")
        ax.set_title("Self-Attention Output Range Patterns Across Timesteps")
        ax.grid(True, linestyle="--", alpha=0.7)
        ax.legend()
        fig.savefig(os.path.join(out_dir, "timestep_pattern_comparison.png"), dpi=150)
        plt.close(fig)

    save_range_report(summary, os.path.join(out_dir, "cross_model_comparison.json"))
    return summary


def load_weights(path: str, cfg: UNetConfig, device):
    """UNet params from a checkpoint: a `.npz` (a param tree, or a training
    state's EMA) or a torch `.ckpt` / `.pth` converted by name."""
    if path.endswith(".npz"):
        from ..checkpoint import load_params

        return load_params(path, unet_init(torch.Generator().manual_seed(0), cfg, "cpu"), device)
    from ..models.torch_convert import load_torch_checkpoint

    return load_torch_checkpoint(path, cfg, device=device)


def main(argv=None):
    import argparse
    import dataclasses

    from ..config import load_config

    ap = argparse.ArgumentParser(description="activation, weight and attention range analysis")
    ap.add_argument("--config", default=None, help="required unless --compare")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="analysis_out")
    ap.add_argument("--timesteps", default="0,250,500,750,999")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--enhanced", action="store_true", help="analyze the enhanced-attention variant")
    ap.add_argument("--compare", default=None, help="comma-separated configs for cross-model attention comparison")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    if not args.compare and not args.config:
        ap.error("--config is required unless --compare is given")
    device = default_device() if args.device is None else torch.device(args.device)
    ts = [int(t) for t in args.timesteps.split(",")]

    def inputs(cfg):
        return torch.randn((args.batch, cfg.resolution, cfg.resolution, cfg.in_channels),
                           generator=torch.Generator(device=device).manual_seed(1), device=device)

    if args.compare:
        reports = {}
        for cfg_path in args.compare.split(","):
            cfg = UNetConfig.from_config(load_config(cfg_path))
            params = unet_init(torch.Generator().manual_seed(0), cfg, device)
            reports[os.path.splitext(os.path.basename(cfg_path))[0]] = collect_attention_ranges(params, cfg,
                                                                                                inputs(cfg), ts)
        cross_model_comparison(reports, ts, args.out)
        print(f"cross-model comparison written to {args.out}/")
        return 0

    cfg = UNetConfig.from_config(load_config(args.config))
    if args.enhanced:
        cfg = dataclasses.replace(cfg, attn_variant="enhanced")
    params = (load_weights(args.ckpt, cfg, device) if args.ckpt
              else unet_init(torch.Generator().manual_seed(0), cfg, device))
    x = inputs(cfg)

    act = collect_activation_ranges(params, cfg, x, ts)
    save_range_report(act, os.path.join(args.out, "activation_ranges.json"))
    plot_activation_ranges(act, ts, os.path.join(args.out, "activation_ranges.png"))

    wr = collect_weight_ranges(params, cfg)
    save_range_report(wr, os.path.join(args.out, "weight_ranges.json"))
    plot_weight_ranges_qdiffusion_style(wr, os.path.join(args.out, "weight_ranges.png"))

    ar = collect_attention_ranges(params, cfg, x, ts)
    save_range_report(ar, os.path.join(args.out, "attention_ranges.json"))
    plot_attention_heatmaps(ar, ts, os.path.join(args.out, "attention_heatmap.png"))
    print(f"analysis written to {args.out}/")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
