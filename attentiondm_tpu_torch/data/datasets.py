"""Dataset readers (port of the SYNTHETIC and CIFAR10 readers of
`attentiondm_tpu/data/datasets.py`).

Both return float32 NHWC images in [0, 1] and an integer label through
`__getitem__` / `__len__`, as numpy on the host (the loader's batches go to
the device whole).  CIFAR-10 reads the standard `cifar-10-batches-py`
pickles and downloads nothing.  The other datasets (CelebA, LSUN, FFHQ,
ImageNet-64 and their lmdb / image-folder readers) are ROADMAP Queue 1
item 7 and raise NotImplementedError.
"""
from __future__ import annotations

import os
import pickle

import numpy as np


class SyntheticDataset:
    """Deterministic uniform [0, 1] images (`default_rng(seed).random`); the label is always 0."""

    def __init__(self, n: int, image_size: int, channels: int = 3, seed: int = 0):
        self.n = n
        self.data = np.random.default_rng(seed).random((n, image_size, image_size, channels), dtype=np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.data[i], 0


class Cifar10Dataset:
    """CIFAR-10 from `<root>/cifar-10-batches-py` (data_batch_1..5 for the
    training split, test_batch for the test split): uint8 CHW rows / 255 as
    NHWC float32.  It takes no flip (JAX's reader ignores `random_flip` for
    CIFAR-10 too)."""

    def __init__(self, root: str, train: bool = True):
        base = os.path.join(root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"CIFAR-10 not found at {base}; place the extracted "
                "cifar-10-batches-py directory there (no download egress)."
            )
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        xs, ys = [], []
        for f in files:
            with open(os.path.join(base, f), "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.data = (x / 255.0).astype(np.float32)
        self.labels = np.asarray(ys, np.int64)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], int(self.labels[i])


def write_cifar10(root: str, images: np.ndarray, labels, n_test: int):
    """Write uint8 NHWC `images` and `labels` in CIFAR-10's pickle layout
    under `<root>/cifar-10-batches-py`: the last `n_test` in test_batch, the
    others split evenly over data_batch_1..5 (a seeded stand-in where the
    real files are absent)."""
    n_train = len(images) - n_test
    if n_train % 5:
        raise ValueError(f"write_cifar10: {n_train} training images do not split over 5 files")
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rows = np.ascontiguousarray(images.transpose(0, 3, 1, 2)).reshape(len(images), -1).astype(np.uint8)
    labels = [int(v) for v in labels]
    per = n_train // 5
    bounds = [(j * per, (j + 1) * per) for j in range(5)] + [(n_train, len(images))]
    for name, (lo, hi) in zip([f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"], bounds):
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": rows[lo:hi], b"labels": labels[lo:hi]}, fh)


def get_dataset(args, config):
    """(train, test) datasets by `config.data.dataset` under `<args.exp>/datasets`."""
    d = config.data
    name = d.dataset.upper()
    root = os.path.join(getattr(args, "exp", "exp"), "datasets")
    if name == "SYNTHETIC":
        n = getattr(d, "num_synthetic", 256)
        return (SyntheticDataset(n, d.image_size, d.channels, seed=0),
                SyntheticDataset(max(1, n // 10), d.image_size, d.channels, seed=1))
    if name == "CIFAR10":
        r = os.path.join(root, "cifar10")
        return Cifar10Dataset(r, train=True), Cifar10Dataset(r, train=False)
    raise NotImplementedError(f"dataset {d.dataset}: not ported yet (ROADMAP Queue 1 item 7, the datasets and their "
                              "readers); the port reads SYNTHETIC and CIFAR10")
