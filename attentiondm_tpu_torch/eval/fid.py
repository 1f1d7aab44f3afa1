"""FID (port of `attentiondm_tpu/eval/fid.py`, pytorch-fid's semantics).

Activation statistics from a feature extractor, the Frechet distance
||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), path handling (`.npz`
statistics or an image folder) and the CLI:

    python -m attentiondm_tpu_torch.eval.fid path1 path2 [--inception-weights W.pth] [--batch-size 64]
    python -m attentiondm_tpu_torch.eval.fid folder stats.npz --save-stats

Features run on the CUDA device unless a caller passes `device="cpu"`
(`--device cpu`); only the 2048 x 2048 square root stays on the host
(scipy), as in JAX.  `.npz` statistics (`mu`, `sigma`) are JAX's format.

PNGs are decoded by `utils/images.read_png` (no imaging package); other
extensions need PIL and raise naming the file where it is not installed.
"""
from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from .. import default_device
from ..ops.precision import exact_f32
from ..utils.images import read_png, to_rgb

IMAGE_EXTENSIONS = {"bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp"}


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """Frechet distance between two Gaussians (fid_score.py:152-206)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))  # no `disp=`: newer scipy removed it (the card's has)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def frechet_smoke_safe(mu1, sigma1, mu2, sigma2, n1):
    """The Frechet distance, real-valued at smoke scale: with fewer samples
    than feature dims (n1 < D) sigma1 is rank-deficient and sqrtm(S1 S2)
    goes complex, so tr((S1 S2)^1/2) is summed as sqrt of the eigenvalues
    (exact for PSD inputs).  At n1 >= D, `calculate_frechet_distance`."""
    if n1 >= sigma1.shape[0]:
        return calculate_frechet_distance(mu1, sigma1, mu2, sigma2)
    d = np.asarray(mu1) - np.asarray(mu2)
    ev = np.linalg.eigvals(np.asarray(sigma1) @ np.asarray(sigma2))
    return float(d @ d + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.sqrt(np.clip(ev.real, 0, None)).sum())


def _device(device):
    return default_device() if device is None else torch.device(device)


@torch.no_grad()
def get_activations(images_iter, extract_fn, batch_size=64, device=None):
    """Features [total, D] (numpy) of a stream of [N, H, W, C] float [0, 1]
    batches, each run through `extract_fn` on `device` under `exact_f32()`."""
    dev = _device(device)
    feats = []
    with exact_f32():
        for batch in images_iter:
            feats.append(extract_fn(torch.as_tensor(batch, dtype=torch.float32, device=dev)).cpu().numpy())
    return np.concatenate(feats, axis=0)


def calculate_activation_statistics(images_iter, extract_fn, batch_size=64, device=None):
    act = get_activations(images_iter, extract_fn, batch_size, device)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def _decode(f: pathlib.Path) -> np.ndarray:
    """uint8 RGB [H, W, 3] of one image file: PNGs by `read_png`, the rest by PIL."""
    if f.suffix.lower() == ".png":
        return to_rgb(read_png(str(f)))
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{f}: decoding a .{f.suffix[1:]} file needs PIL, which is not installed "
                           "(PNGs need nothing)") from e
    return np.asarray(Image.open(f).convert("RGB"))


def _iter_image_dir(path, batch_size):
    """[b, H, W, 3] float [0, 1] batches of the folder's images, in sorted path order."""
    path = pathlib.Path(path)
    files = sorted(f for ext in IMAGE_EXTENSIONS for f in path.glob(f"*.{ext}"))
    if not files:
        raise RuntimeError(f"no images found in {path}")
    batch = []
    for f in files:
        batch.append(_decode(f).astype(np.float32) / 255.0)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def compute_statistics_of_path(path, extract_fn, batch_size=64, device=None):
    """Path -> (mu, sigma): a `.npz` file holds precomputed statistics
    (fid_score.py:234-246); a folder is globbed for images."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    return calculate_activation_statistics(_iter_image_dir(path, batch_size), extract_fn, batch_size, device)


def calculate_fid_given_paths(paths, extract_fn, batch_size=64, device=None):
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    m1, s1 = compute_statistics_of_path(paths[0], extract_fn, batch_size, device)
    m2, s2 = compute_statistics_of_path(paths[1], extract_fn, batch_size, device)
    return calculate_frechet_distance(m1, s1, m2, s2)


def save_fid_stats(paths, extract_fn, batch_size=64, device=None):
    """Statistics of paths[0] saved to paths[1] (.npz; fid_score.py:268-285)."""
    mu, sigma = compute_statistics_of_path(paths[0], extract_fn, batch_size, device)
    np.savez_compressed(paths[1], mu=mu, sigma=sigma)


@torch.no_grad()
def sharded_statistics(images, extract_fn, mesh=None, batch_size=256, device=None):
    """(mu, sigma) from sums of f and f f^T accumulated on the device in
    float32, as JAX does; only [D] and [D, D] come back to the host, where
    sigma = (sum f f^T - n mu mu^T) / (n - 1) in float32.

    `images` is one [N, H, W, C] array (sliced into `batch_size` chunks) or
    an iterable of batches (a streaming sampler).  With a `mesh`
    (`parallel.make_mesh`) of several data ranks, every rank walks the same
    batches and extracts its contiguous share of each (JAX's device order),
    and the two sums are all-reduced over `data` at the end; the ranks of
    any other axis repeat their data rank's work, as GSPMD replicates JAX's
    over `model`."""
    dev = _device(device)
    n_dev = 1 if mesh is None else mesh.shape.get("data", 1)
    if hasattr(images, "shape"):
        batches = (images[i:i + batch_size] for i in range(0, len(images), batch_size))
    else:
        batches = iter(images)
    s1 = s2 = None
    n_total = 0
    with exact_f32():
        for b in batches:
            n_total += len(b)
            if n_dev > 1:  # this rank's share: contiguous, as even as the batch allows
                lo, hi = (len(b) * mesh.index("data") // n_dev, len(b) * (mesh.index("data") + 1) // n_dev)
                b = b[lo:hi]
                if not len(b):
                    continue
            f = extract_fn(torch.as_tensor(b, dtype=torch.float32, device=dev)).float()
            fs, ffT = f.sum(dim=0), f.T @ f
            s1 = fs if s1 is None else s1 + fs
            s2 = ffT if s2 is None else s2 + ffT
    if n_dev > 1:
        from ..parallel.collectives import all_reduce

        s1, s2 = all_reduce(s1, mesh.groups["data"]), all_reduce(s2, mesh.groups["data"])
    mu = s1.cpu().numpy() / n_total
    sigma = (s2.cpu().numpy() - n_total * np.outer(mu, mu)) / (n_total - 1)
    return mu, sigma


def main(argv=None):
    """CLI: the FID between two paths, or --save-stats of the first into the second."""
    import argparse

    p = argparse.ArgumentParser(description="FID between two paths (image folders or .npz statistics)")
    p.add_argument("path", nargs=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--inception-weights", type=str, default=None,
                   help="the pt_inception state dict to load (required for canonical FID)")
    p.add_argument("--save-stats", action="store_true", help="compute the statistics of path[0], save to path[1]")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from .inception import InceptionV3FID

    dev = _device(args.device)
    if args.inception_weights:
        net = InceptionV3FID.from_torch(args.inception_weights, device=dev)
    else:
        print("WARNING: no --inception-weights given; using random features "
              "(relative comparisons only, NOT canonical FID)")
        net = InceptionV3FID.random(device=dev)

    if args.save_stats:
        save_fid_stats(args.path, net.extract, args.batch_size, dev)
        return 0
    fid = calculate_fid_given_paths(args.path, net.extract, args.batch_size, dev)
    print("FID: ", fid)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
