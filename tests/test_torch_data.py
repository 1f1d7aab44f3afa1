"""PyTorch port vs the JAX package: the data and logging modules of the
training half (`data/loader.py`, `data/datasets.py`, `data/synthetic.py`,
`utils/metrics_log.py`, `utils/tb_writer.py`).

The loader and the datasets are numpy in both packages and held byte-equal.
The on-device image distributions take their draws as arguments: these
tests derive the draws JAX's keys give (`jax.random`, the same splits as
`attentiondm_tpu/data/synthetic.py`) and hold the port's images to JAX's at
1e-5 (procedural: float32 sigmoid and cos in other libraries) and 1e-4
(natural: two FFTs in other libraries, then a division by the image's sd).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.config import dict2namespace
from attentiondm_tpu.data import datasets as jdatasets
from attentiondm_tpu.data import synthetic as jsynthetic
from attentiondm_tpu.data.loader import iterate_batches as j_iterate_batches
from attentiondm_tpu.utils import metrics_log as jmetrics
from attentiondm_tpu.utils import tb_writer as jtb
from attentiondm_tpu_torch.data import datasets, synthetic
from attentiondm_tpu_torch.data.loader import iterate_batches
from attentiondm_tpu_torch.utils import metrics_log, tb_writer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)])
def test_iterate_batches_byte_equal(workers, shuffle, drop_last):
    """The same batches, bytes and order, as JAX's loader, at 0 and 2 workers."""
    ds = datasets.SyntheticDataset(37, 8, 3, seed=3)
    got = list(iterate_batches(ds, 8, shuffle=shuffle, seed=11, drop_last=drop_last, workers=workers))
    want = list(j_iterate_batches(jdatasets.SyntheticDataset(37, 8, 3, seed=3), 8, shuffle=shuffle, seed=11,
                                  drop_last=drop_last, workers=0))
    assert len(got) == len(want) == (4 if drop_last else 5)
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == wx.dtype == np.float32 and x.tobytes() == wx.tobytes()
        np.testing.assert_array_equal(y, wy)


def test_synthetic_dataset_byte_equal():
    a, b = datasets.SyntheticDataset(20, 16, 3, seed=1), jdatasets.SyntheticDataset(20, 16, 3, seed=1)
    assert len(a) == len(b) == 20 and a.data.tobytes() == b.data.tobytes() and a[5][1] == b[5][1] == 0


def _write_set(tmp_path, n=60):
    images = np.random.default_rng(0).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = np.random.default_rng(1).integers(0, 10, n)
    root = str(tmp_path / "exp" / "datasets" / "cifar10")
    datasets.write_cifar10(root, images, labels, n_test=10)
    return root, images, labels, n - 10, 10


def test_cifar10_reads_the_pickle_layout_as_jax(tmp_path):
    """A seeded set in CIFAR-10's pickle layout (5 training files, 1 test
    file): both readers give the same bytes, the images / 255 in NHWC."""
    root, images, labels, n_train, n_test = _write_set(tmp_path)
    assert (n_train, n_test) == (50, 10)
    for train, lo, hi in ((True, 0, n_train), (False, n_train, len(images))):
        got, want = datasets.Cifar10Dataset(root, train=train), jdatasets.Cifar10Dataset(root, train=train)
        assert got.data.tobytes() == want.data.tobytes()
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.data, (images[lo:hi] / 255.0).astype(np.float32))
        assert got[3][1] == int(labels[lo + 3])


def test_get_dataset_names_and_raises(tmp_path):
    """SYNTHETIC and CIFAR10 as JAX builds them; a missing CIFAR-10 raises
    JAX's FileNotFoundError text, and so does a missing CelebA, LSUN, FFHQ
    or ImageNet set (their readers: tests/test_torch_datasets.py); a name
    JAX does not read raises NotImplementedError, as JAX's does."""
    args = dict2namespace({"exp": str(tmp_path / "exp")})
    cfg = dict2namespace({"data": {"dataset": "SYNTHETIC", "image_size": 8, "channels": 3, "num_synthetic": 30}})
    (tr, te), (jtr, jte) = datasets.get_dataset(args, cfg), jdatasets.get_dataset(args, cfg)
    assert (len(tr), len(te)) == (len(jtr), len(jte)) == (30, 3)
    assert tr.data.tobytes() == jtr.data.tobytes() and te.data.tobytes() == jte.data.tobytes()
    cfg.data.dataset = "cifar10"
    with pytest.raises(FileNotFoundError) as port_err:
        datasets.get_dataset(args, cfg)
    with pytest.raises(FileNotFoundError) as jax_err:
        jdatasets.get_dataset(args, cfg)
    assert str(port_err.value) == str(jax_err.value)
    _write_set(tmp_path)
    tr, te = datasets.get_dataset(args, cfg)
    assert (len(tr), len(te)) == (50, 10)
    for name in ("CELEBA", "LSUN", "FFHQ", "IMAGENET"):
        cfg.data.dataset = name
        with pytest.raises(FileNotFoundError) as port_err:
            datasets.get_dataset(args, cfg)
        with pytest.raises(FileNotFoundError) as jax_err:
            jdatasets.get_dataset(args, cfg)
        assert str(port_err.value) == str(jax_err.value)
    cfg.data.dataset = "MNIST"
    with pytest.raises(NotImplementedError, match="dataset MNIST"):
        datasets.get_dataset(args, cfg)
    with pytest.raises(NotImplementedError, match="dataset MNIST"):
        jdatasets.get_dataset(args, cfg)


def test_metrics_logger_csv_as_jax(tmp_path, monkeypatch):
    """The same CSV bytes as JAX's MetricsLogger at the same wall clock."""
    outs = []
    for mod, name in ((metrics_log, "port"), (jmetrics, "jax")):
        it = iter(np.arange(100.0, 200.0, 0.25))
        monkeypatch.setattr(mod.time, "time", lambda it=it: float(next(it)))
        log = mod.MetricsLogger(str(tmp_path / name / "train_metrics.csv"))
        for step in (1, 2, 3):
            log.log(step, loss=0.5 / step, data_s=round(0.01 * step, 4), epoch=0)
        outs.append(open(log.path, "rb").read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") == 4
    assert outs[0].splitlines()[0] == b"step,wall_s,loss,data_s,epoch"


def test_event_file_bytes_as_jax(tmp_path, monkeypatch):
    """The same event-file name and bytes as JAX's writer at the same wall time."""
    files = []
    for mod, name in ((tb_writer, "port"), (jtb, "jax")):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.125)
        w = mod.SummaryWriter(str(tmp_path / name))
        for step, v in ((1, 0.75), (2, 0.5), (10, 0.125)):
            w.add_scalar("loss", v, step)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    assert tb_writer.crc32c(b"123456789") == 0xE3069283  # the CRC32C check value


def _jax_shape_draws(key, p_on):
    km, kcol, kon = jax.random.split(key, 3)
    kt, kc, ks, _ = jax.random.split(km, 4)
    return {"center": jax.random.uniform(kc, (2,), minval=0.15, maxval=0.85),
            "size": jax.random.uniform(ks, (2,), minval=0.08, maxval=0.3),
            "is_circle": jax.random.bernoulli(kt), "color": jax.random.uniform(kcol, (3,), minval=-1.0, maxval=1.0),
            "on": jax.random.bernoulli(kon, p_on)}


def _stack(per_image):
    """[{name: array}] per image, with shape lists under "shapes", -> the port's draws dict of tensors."""
    out = {}
    for k in per_image[0]:
        if k == "shapes":
            for f in per_image[0]["shapes"][0]:
                out[f] = torch.from_numpy(np.stack([np.stack([np.asarray(s[f]) for s in im["shapes"]])
                                                    for im in per_image]))
        else:
            out[k] = torch.from_numpy(np.stack([np.asarray(im[k]) for im in per_image]))
    return out


def jax_synthetic_draws(key, batch):
    """The draws `attentiondm_tpu.data.synthetic.synthetic_batch(key, batch)` takes, image by image."""
    ims = []
    for k in jax.random.split(key, batch):
        kb, kf = jax.random.split(k)
        k1, k2, k3 = jax.random.split(kb, 3)
        ims.append({"c0": jax.random.uniform(k1, (3,), minval=-1.0, maxval=1.0),
                    "c1": jax.random.uniform(k2, (3,), minval=-1.0, maxval=1.0),
                    "freq": jax.random.uniform(k3, (4,), minval=-2.0, maxval=2.0),
                    "shapes": [_jax_shape_draws(jax.random.fold_in(kf, i), 0.75)
                               for i in range(synthetic.N_SHAPES)]})
    return _stack(ims)


def jax_natural_draws(key, batch, res):
    """The draws `natural_batch(key, batch, res)` takes, image by image."""
    ims = []
    for k in jax.random.split(key, batch):
        kf, ka, kg, km, ks = jax.random.split(k, 5)
        (kw,) = jax.random.split(kf, 1)
        ims.append({"alpha": jax.random.uniform(ka, (), minval=1.6, maxval=2.4),
                    "white": jax.random.normal(kw, (3, res, res)), "gain_z": jax.random.normal(kg, ()),
                    "mean_z": jax.random.normal(km, (3,)),
                    "shapes": [_jax_shape_draws(jax.random.fold_in(ks, i), 0.5)
                               for i in range(synthetic.N_OCCLUDERS)]})
    return _stack(ims)


@pytest.mark.parametrize("res", [16, 32])
def test_synthetic_images_given_jax_draws(res):
    key = jax.random.PRNGKey(res)
    want = np.asarray(jsynthetic.synthetic_batch(key, 6, res))
    got = synthetic.synthetic_images(jax_synthetic_draws(key, 6), res)
    assert got.shape == (6, res, res, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("res", [16, 32])
def test_natural_images_given_jax_draws(res):
    key = jax.random.PRNGKey(res + 1)
    want = np.asarray(jsynthetic.natural_batch(key, 6, res))
    got = synthetic.natural_images(jax_natural_draws(key, 6, res), res)
    assert got.shape == (6, res, res, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fn", [synthetic.synthetic_batch, synthetic.natural_batch])
def test_batches_from_a_generator(fn):
    """Drawn from a torch.Generator: in [-1, 1], deterministic in the seed, varied across images."""
    a = fn(torch.Generator().manual_seed(0), 8, 16)
    b = fn(torch.Generator().manual_seed(0), 8, 16)
    c = fn(torch.Generator().manual_seed(1), 8, 16)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (8, 16, 16, 3) and float(a.abs().max()) <= 1.0 and float(a.std(dim=0).mean()) > 0.05
    assert jnp.asarray(a.numpy()).dtype == jnp.float32
