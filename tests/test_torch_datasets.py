"""PyTorch port vs the JAX package: the dataset readers of
`data/datasets.py` (CelebA in both layouts, LSUN lmdb and folder, FFHQ lmdb
and folder with the seeded split, ImageNet's folder, `_SubsetDataset`) and
`data/download.py`, on fixtures written in the test with PIL.

Every array equals JAX's to the bit (the same PIL decode, crop, BILINEAR
resize and float32 / 255); with `random_flip` both draw from numpy's
global generator, so the same `np.random.seed` gives the same flips."""
import hashlib
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from attentiondm_tpu.data import datasets as jd
from attentiondm_tpu.data import download as jdl
from attentiondm_tpu.data import lmdb_reader as jl
from attentiondm_tpu.data.loader import iterate_batches as j_iterate
from attentiondm_tpu_torch.data import datasets as td
from attentiondm_tpu_torch.data import download as tdl
from attentiondm_tpu_torch.data.loader import iterate_batches


def _image(seed, size):
    """A seeded RGB image (noise over a gradient) of PIL size (w, h)."""
    w, h = size
    rng = np.random.default_rng(seed)
    grad = np.linspace(0, 255, w)[None, :, None] * np.ones((h, 1, 3))
    return Image.fromarray(np.clip(grad * 0.5 + rng.integers(0, 128, (h, w, 3)), 0, 255).astype(np.uint8))


def _bytes(img, fmt):
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def _config(name, size, flip=False, **extra):
    return SimpleNamespace(data=SimpleNamespace(dataset=name, image_size=size, random_flip=flip, **extra))


def _celeba_official(root, n=10):
    img_dir = root / "datasets" / "celeba" / "img_align_celeba"
    img_dir.mkdir(parents=True)
    lines = []
    for i in range(n):
        name = f"{i + 1:06d}.jpg"
        _image(i, (178, 218)).save(img_dir / name, quality=90)
        lines.append(f"{name} {(0, 0, 0, 0, 1, 2)[i % 6]}\n")
    (root / "datasets" / "celeba" / "list_eval_partition.txt").write_text("".join(lines))


def _folder(d, n, size, fmt="png", seed=0):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        _image(seed + i, size).save(d / f"{i:04d}.{fmt}")


def _equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        (x, y), (xj, yj) = a[i], b[i]
        assert x.dtype == np.float32 and x.shape == xj.shape and y == yj == 0
        np.testing.assert_array_equal(x, xj)


def _both(tmp_path, config, seed=None):
    """(port's (train, test), JAX's) of get_dataset, each read whole after `np.random.seed(seed)`."""
    args = SimpleNamespace(exp=str(tmp_path))
    out = []
    for get in (td.get_dataset, jd.get_dataset):
        if seed is not None:
            np.random.seed(seed)
        train, test = get(args, config)
        out.append(([train[i] for i in range(len(train))], [test[i] for i in range(len(test))]))
    return out


@pytest.mark.parametrize("flip", [False, True])
def test_celeba_official_layout_equals_jax(tmp_path, flip):
    _celeba_official(tmp_path)
    (tr, te), (jtr, jte) = _both(tmp_path, _config("CELEBA", 64, flip), seed=3)
    assert (len(tr), len(te)) == (8, 1)
    _equal(tr, jtr)
    _equal(te, jte)
    if flip:  # some images flipped, some not: the draws were used
        plain, _ = _both(tmp_path, _config("CELEBA", 64, False))[0]
        flipped = [not np.array_equal(a[0], b[0]) for a, b in zip(tr, plain)]
        assert any(flipped) and not all(flipped)


@pytest.mark.parametrize("layout", ["train_test", "flat"])
def test_celeba_folder_layout_equals_jax(tmp_path, layout):
    r = tmp_path / "datasets" / "celeba"
    if layout == "train_test":
        _folder(r / "train", 5, (178, 218), "jpg")
        _folder(r / "test", 3, (178, 218), "jpg", seed=10)
    else:
        _folder(r, 4, (178, 218), "png")
    (tr, te), (jtr, jte) = _both(tmp_path, _config("CELEBA", 32))
    _equal(tr, jtr)
    _equal(te, jte)
    assert len(te) == (3 if layout == "train_test" else 4)


def _lsun(tmp_path, cat, val=True):
    root = tmp_path / "datasets" / "lsun"
    root.mkdir(parents=True)
    for split, n in (("train", 7), ("val", 3))[: 2 if val else 1]:
        items = {f"{split}{i:04d}".encode(): _bytes(_image(i, (40 + 7 * i, 30 + 3 * i)), "WEBP" if i % 2 else "JPEG")
                 for i in range(n)}
        jl.write_lmdb(str(root / f"{cat}_{split}_lmdb") + os.sep, items)


@pytest.mark.parametrize("val", [True, False])
def test_lsun_lmdb_equals_jax(tmp_path, val):
    _lsun(tmp_path, "church_outdoor", val)
    (tr, te), (jtr, jte) = _both(tmp_path, _config("LSUN", 24, category="church_outdoor"))
    _equal(tr, jtr)
    _equal(te, jte)
    assert len(tr) == 7 and len(te) == (3 if val else 7)
    assert (tmp_path / "datasets" / "lsun" / "_cache_church_outdoor_train_lmdb").is_file()


def test_lsun_key_cache_is_read(tmp_path):
    """A key cache beside the lmdb is taken as it is (reversed here), as JAX's reader takes it."""
    import pickle

    _lsun(tmp_path, "bedroom", val=False)
    db = tmp_path / "datasets" / "lsun" / "bedroom_train_lmdb"
    keys = sorted(jl.LMDBReader(str(db)).keys())[::-1]
    with open(db.parent / "_cache_bedroom_train_lmdb", "wb") as f:
        pickle.dump(keys, f)
    ours, theirs = td.LSUNClassDataset(str(db), 16), jd.LSUNClassDataset(str(db), 16)
    assert ours.keys == keys
    _equal([ours[i] for i in range(len(ours))], [theirs[i] for i in range(len(theirs))])


def test_lsun_folder_and_missing(tmp_path):
    _folder(tmp_path / "datasets" / "lsun" / "bedroom", 4, (50, 40))
    (tr, te), (jtr, jte) = _both(tmp_path, _config("LSUN", 16, True, category="bedroom"), seed=1)
    _equal(tr, jtr)
    _equal(te, jte)
    cfg = _config("LSUN", 16, category="tower")
    with pytest.raises(FileNotFoundError) as ours:
        td.get_dataset(SimpleNamespace(exp=str(tmp_path)), cfg)
    with pytest.raises(FileNotFoundError) as theirs:
        jd.get_dataset(SimpleNamespace(exp=str(tmp_path)), cfg)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("flip", [False, True])
def test_ffhq_lmdb_split_equals_jax(tmp_path, flip):
    n = 20
    items = {b"length": str(n).encode()}
    for i in range(n):
        items[f"32-{i:05d}".encode()] = _bytes(_image(i, (32, 32) if i % 3 else (48, 48)), "PNG")
    (tmp_path / "datasets").mkdir()
    jl.write_lmdb(str(tmp_path / "datasets" / "ffhq") + os.sep, items)
    (tr, te), (jtr, jte) = _both(tmp_path, _config("FFHQ", 32, flip), seed=5)
    assert (len(tr), len(te)) == (18, 2)
    _equal(tr, jtr)
    _equal(te, jte)
    tri, tei = td.ffhq_split_indices(n)
    jtri, jtei = jd.ffhq_split_indices(n)
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_array_equal(tei, jtei)
    assert not set(tri) & set(tei)


def test_ffhq_lmdb_without_length_raises(tmp_path):
    db = tmp_path / "db"
    jl.write_lmdb(str(db) + os.sep, {b"32-00000": b"x"})
    with pytest.raises(FileNotFoundError, match="not an FFHQ lmdb"):
        td.FFHQLmdbDataset(str(db), 32)


def test_ffhq_folder_split_equals_jax(tmp_path):
    _folder(tmp_path / "datasets" / "ffhq" / "a", 6, (40, 40))
    _folder(tmp_path / "datasets" / "ffhq" / "b", 5, (40, 40), seed=20)
    (tr, te), (jtr, jte) = _both(tmp_path, _config("FFHQ", 16, True), seed=2)
    assert (len(tr), len(te)) == (9, 2)
    _equal(tr, jtr)
    _equal(te, jte)


def test_imagenet_folder_equals_jax_and_loader(tmp_path):
    _folder(tmp_path / "datasets" / "imagenet64" / "n01", 5, (64, 64))
    _folder(tmp_path / "datasets" / "imagenet64" / "n02", 4, (80, 60), "jpg", seed=9)
    (tr, te), (jtr, jte) = _both(tmp_path, _config("IMAGENET", 64))
    _equal(tr, jtr)
    _equal(te, jte)
    train, _ = td.get_dataset(SimpleNamespace(exp=str(tmp_path)), _config("IMAGENET", 64))
    jtrain, _ = jd.get_dataset(SimpleNamespace(exp=str(tmp_path)), _config("IMAGENET", 64))
    for (x, y), (xj, yj) in zip(iterate_batches(train, 4, seed=1, workers=2),
                                j_iterate(jtrain, 4, seed=1), strict=True):
        np.testing.assert_array_equal(x, np.asarray(xj))
        np.testing.assert_array_equal(y, np.asarray(yj))


def test_image_folder_crop_and_subset_equal_jax(tmp_path):
    _folder(tmp_path / "f", 4, (178, 218), "jpg")
    box = td.celeba_crop_box()
    assert box == jd.celeba_crop_box() == (25, 57, 153, 185)
    ours, theirs = td.ImageFolderDataset(str(tmp_path / "f"), 48, crop_box=box), jd.ImageFolderDataset(
        str(tmp_path / "f"), 48, crop_box=box)
    assert ours.paths == theirs.paths
    _equal([ours[i] for i in range(4)], [theirs[i] for i in range(4)])
    sub, jsub = td._SubsetDataset(ours, [3, 0]), jd._SubsetDataset(theirs, [3, 0])
    _equal([sub[i] for i in range(2)], [jsub[i] for i in range(2)])
    with pytest.raises(FileNotFoundError, match="no images under"):
        td.ImageFolderDataset(str(tmp_path / "none"), 8)


def test_undecodable_image_raises(tmp_path):
    d = tmp_path / "datasets" / "imagenet64"
    d.mkdir(parents=True)
    (d / "broken.png").write_bytes(b"not a png")
    train, _ = td.get_dataset(SimpleNamespace(exp=str(tmp_path)), _config("IMAGENET", 8))
    with pytest.raises(Exception, match="cannot identify image file"):
        train[0]


def test_unknown_dataset_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="dataset MNIST"):
        td.get_dataset(SimpleNamespace(exp=str(tmp_path)), _config("MNIST", 8))


def test_check_md5_and_download_raise(tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(os.urandom(3 << 20))
    md5 = hashlib.md5(f.read_bytes()).hexdigest()
    assert tdl.check_md5(str(f), md5) is jdl.check_md5(str(f), md5) is True
    assert tdl.check_md5(str(f), "0" * 32) is jdl.check_md5(str(f), "0" * 32) is False
    assert tdl.download_url("https://example.invalid/x/a.bin", str(tmp_path), md5=md5) == str(f)
    assert tdl.download_url("https://example.invalid/x/a.bin", str(tmp_path)) == str(f)
    assert tdl.download_file_from_google_drive("id0", str(tmp_path), "a.bin", md5) == str(f)
    missing = str(tmp_path / "sub" / "b.bin")
    with pytest.raises(FileNotFoundError) as e:
        tdl.download_url("https://example.invalid/x/b.bin", str(tmp_path / "sub"), md5="ab" * 16)
    assert missing in str(e.value) and "ab" * 16 in str(e.value)
    with pytest.raises(FileNotFoundError, match="fails md5 verification"):
        tdl.download_file_from_google_drive("id0", str(tmp_path), "a.bin", "0" * 32)
    with pytest.raises(FileNotFoundError, match="Google Drive file id1"):
        tdl.download_file_from_google_drive("id1", str(tmp_path), "c.bin")
    assert not os.path.exists(tmp_path / "sub")  # nothing made, nothing fetched


def test_exports_match_jax():
    import attentiondm_tpu.data as j
    import attentiondm_tpu_torch.data as t

    assert set(j.__all__) - {"inverse_transform_uint8_fn"} == set(t.__all__) - {"inverse_transform_uint8"}
    for name in ("CelebADataset", "LSUNClassDataset", "FFHQLmdbDataset", "LMDBReader", "write_lmdb"):
        assert hasattr(t, name)
