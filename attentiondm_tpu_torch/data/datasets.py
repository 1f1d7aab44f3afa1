"""Dataset readers (port of `attentiondm_tpu/data/datasets.py`).

Every reader returns a float32 NHWC image in [0, 1] and an integer label
through `__getitem__` / `__len__`, as numpy on the host (the loader's
batches go to the device whole).  CIFAR-10 reads the standard
`cifar-10-batches-py` pickles; CelebA its official `list_eval_partition.txt`
split with the reference's 128x128 face crop before the resize (or an image
folder); LSUN and FFHQ their lmdb databases through the pure-Python reader
`data/lmdb_reader.py` (or an image folder); ImageNet-64 an image folder.
Images decode with PIL, crop and resize (BILINEAR) and divide by 255
exactly as JAX's readers do, so the arrays are JAX's to the bit; a
`random_flip` draws from numpy's global generator, as JAX's does.  Nothing
is downloaded.
"""
from __future__ import annotations

import io
import logging
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


class ImageFolderDataset:
    """A folder (walked recursively, files sorted within each directory) of
    images, each decoded to RGB, cropped to `crop_box` (left, upper, right,
    lower) where one is given, resized to image_size^2 (BILINEAR) and
    flipped left-right with probability 1/2 under `flip`.  `paths` replaces
    the walk."""

    EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

    def __init__(self, root: str, image_size: int, crop_box=None, flip: bool = False, paths=None):
        self.root = root
        self.image_size = image_size
        self.crop_box = crop_box
        self.flip = flip
        if paths is None:
            paths = []
            for dirpath, _dirs, files in os.walk(root):
                for f in sorted(files):
                    if f.lower().endswith(self.EXTS):
                        paths.append(os.path.join(dirpath, f))
            if not paths:
                raise FileNotFoundError(f"no images under {root}")
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        from PIL import Image

        img = Image.open(self.paths[i]).convert("RGB")
        if self.crop_box is not None:
            img = img.crop(self.crop_box)
        img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        return _to_array(img, self.flip), 0


def _to_array(img, flip: bool) -> np.ndarray:
    """A PIL RGB image as float32 [H, W, 3] / 255, flipped left-right with
    probability 1/2 (numpy's global generator) under `flip`."""
    x = np.asarray(img, np.float32) / 255.0
    if flip and np.random.random() < 0.5:
        x = x[:, ::-1].copy()
    return x


class _SubsetDataset:
    """The items of `base` at `indices`, in that order."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[int(self.indices[i])]


def celeba_crop_box():
    """The reference's CelebA face crop: centre (89, 121), 64 pixels each
    way, as a PIL box (left, upper, right, lower) of 128x128."""
    cx, cy, half = 89, 121, 64
    return (cx - half, cy - half, cx + half, cy + half)


class CelebADataset:
    """CelebA's official layout: `<root>/list_eval_partition.txt` (file
    name -> 0 train, 1 valid, 2 test) and `<root>/img_align_celeba/*.jpg`,
    read in the partition file's order with `celeba_crop_box`.  The label is
    always 0 (the attribute, identity and landmark targets are not read)."""

    SPLITS = {"train": 0, "valid": 1, "test": 2}

    def __init__(self, root: str, image_size: int, split: str = "train", flip: bool = False):
        part = os.path.join(root, "list_eval_partition.txt")
        if not os.path.isfile(part):
            raise FileNotFoundError(part)
        want = self.SPLITS[split]
        img_dir = os.path.join(root, "img_align_celeba")
        names = []
        with open(part) as f:
            for line in f:
                cols = line.split()
                if len(cols) >= 2 and int(cols[1]) == want:
                    names.append(cols[0])
        self._inner = ImageFolderDataset(img_dir, image_size, crop_box=celeba_crop_box(), flip=flip,
                                         paths=[os.path.join(img_dir, n) for n in names])

    def __len__(self):
        return len(self._inner)

    def __getitem__(self, i):
        return self._inner[i]


class LSUNClassDataset:
    """One LSUN class from its lmdb: the keys are cached (pickled) to
    `_cache_<dirname>` beside the lmdb directory, each image decodes from
    its stored bytes, then Resize(shortest side = image_size, BILINEAR) and
    CenterCrop(image_size)."""

    def __init__(self, root: str, image_size: int, flip: bool = False):
        from .lmdb_reader import LMDBReader

        self.db = LMDBReader(root)
        self.image_size = image_size
        self.flip = flip
        root = root.rstrip(os.sep)
        cache_file = os.path.join(os.path.dirname(root), f"_cache_{os.path.basename(root)}")
        if os.path.isfile(cache_file):
            with open(cache_file, "rb") as f:
                self.keys = pickle.load(f)
        else:
            self.keys = self.db.keys()
            with open(cache_file, "wb") as f:
                pickle.dump(self.keys, f)

    def __len__(self):
        return len(self.db)

    def __getitem__(self, i):
        from PIL import Image

        img = Image.open(io.BytesIO(self.db.get(self.keys[i]))).convert("RGB")
        s = self.image_size
        w, h = img.size
        scale = s / min(w, h)
        img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))), Image.BILINEAR)
        w, h = img.size
        left, top = (w - s) // 2, (h - s) // 2
        img = img.crop((left, top, left + s, top + s))
        return _to_array(img, self.flip), 0


class FFHQLmdbDataset:
    """FFHQ's lmdb: the entry count under the key `length`, image i under
    `f"{resolution}-{i:05d}"`, resized to image_size^2 (BILINEAR) where it
    is another size."""

    def __init__(self, root: str, image_size: int, resolution: int = 256, flip: bool = False):
        from .lmdb_reader import LMDBReader

        self.db = LMDBReader(root)
        self.image_size = image_size
        self.resolution = resolution
        self.flip = flip
        length = self.db.get(b"length")
        if length is None:
            raise FileNotFoundError(f"{root}: no 'length' key — not an FFHQ lmdb")
        self.length = int(length.decode("utf-8"))

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        from PIL import Image

        key = f"{self.resolution}-{str(i).zfill(5)}".encode("utf-8")
        img = Image.open(io.BytesIO(self.db.get(key))).convert("RGB")
        if img.size != (self.image_size, self.image_size):
            img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        return _to_array(img, self.flip), 0


def ffhq_split_indices(n: int):
    """The reference's seeded 90/10 split: a `RandomState(2019)`
    permutation, train the first 90%, test the last 10%."""
    indices = np.random.RandomState(2019).permutation(n)
    cut = int(n * 0.9)
    return indices[:cut], indices[cut:]


class FFHQDataset(ImageFolderDataset):
    """An FFHQ image folder under `ffhq_split_indices`' train or test part."""

    def __init__(self, root: str, image_size: int, train: bool = True, flip: bool = False):
        paths = ImageFolderDataset(root, image_size).paths
        tr, te = ffhq_split_indices(len(paths))
        super().__init__(root, image_size, flip=flip, paths=[paths[i] for i in (tr if train else te)])


def get_dataset(args, config):
    """(train, test) datasets by `config.data.dataset` under
    `<args.exp>/datasets/<name>`; `config.data.random_flip` flips the
    training images of every reader but CIFAR-10's (as in JAX)."""
    d = config.data
    name = d.dataset.upper()
    root = os.path.join(getattr(args, "exp", "exp"), "datasets")
    flip = bool(getattr(d, "random_flip", False))

    if name == "SYNTHETIC":
        n = getattr(d, "num_synthetic", 256)
        return (SyntheticDataset(n, d.image_size, d.channels, seed=0),
                SyntheticDataset(max(1, n // 10), d.image_size, d.channels, seed=1))
    if name == "CIFAR10":
        r = os.path.join(root, "cifar10")
        return Cifar10Dataset(r, train=True), Cifar10Dataset(r, train=False)
    if name == "CELEBA":
        r = os.path.join(root, "celeba")
        if os.path.isfile(os.path.join(r, "list_eval_partition.txt")):
            return (CelebADataset(r, d.image_size, split="train", flip=flip),
                    CelebADataset(r, d.image_size, split="test"))
        box = celeba_crop_box()
        train = ImageFolderDataset(os.path.join(r, "train") if os.path.isdir(os.path.join(r, "train")) else r,
                                   d.image_size, crop_box=box, flip=flip)
        testdir = os.path.join(r, "test")
        test = ImageFolderDataset(testdir, d.image_size, crop_box=box) if os.path.isdir(testdir) else train
        return train, test
    if name == "LSUN":
        cat = getattr(d, "category", "bedroom")
        lsun_root = os.path.join(root, "lsun")
        train_db = os.path.join(lsun_root, f"{cat}_train_lmdb")
        val_db = os.path.join(lsun_root, f"{cat}_val_lmdb")
        if os.path.isdir(train_db):
            train = LSUNClassDataset(train_db, d.image_size, flip=flip)
            if os.path.isdir(val_db):
                test = LSUNClassDataset(val_db, d.image_size)
            else:
                logging.warning(f"LSUN/{cat}: no val lmdb at {val_db}; evaluation will run on the TRAINING set")
                test = train
            return train, test
        r = os.path.join(lsun_root, cat)
        if not os.path.isdir(r):
            raise FileNotFoundError(f"LSUN/{cat}: expected lmdb at {train_db} or an image folder at {r}.")
        ds = ImageFolderDataset(r, d.image_size, flip=flip)
        return ds, ds
    if name == "FFHQ":
        r = os.path.join(root, "ffhq")
        if os.path.isfile(os.path.join(r, "data.mdb")) or r.endswith(".mdb"):
            res = getattr(d, "image_size", 256)
            ds = FFHQLmdbDataset(r, d.image_size, resolution=res, flip=flip)
            tr, te = ffhq_split_indices(len(ds))
            return _SubsetDataset(ds, tr), _SubsetDataset(FFHQLmdbDataset(r, d.image_size, resolution=res), te)
        return FFHQDataset(r, d.image_size, train=True, flip=flip), FFHQDataset(r, d.image_size, train=False)
    if name == "IMAGENET":
        ds = ImageFolderDataset(os.path.join(root, "imagenet64"), d.image_size, flip=flip)
        return ds, ds
    raise NotImplementedError(f"dataset {d.dataset}")
