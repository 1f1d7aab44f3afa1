"""PyTorch port vs the JAX package: image output.  The port's PNG writer
(standard library only) against JAX's `save_image` / `save_image_grid`
(PIL) and `native.write_png_batch`: the files differ in their bytes, their
pixels (decoded by PIL here) must not.  The model-space transforms and the
uint8 inverse against JAX's."""
import argparse
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from attentiondm_tpu.data import transforms as jtf
from attentiondm_tpu.native import write_png_batch as j_write_png_batch
from attentiondm_tpu.utils import images as jimg
from attentiondm_tpu_torch.data import transforms as tf
from attentiondm_tpu_torch.utils import images


def _pixels(path):
    return np.asarray(Image.open(path))


def _config(**data):
    return argparse.Namespace(data=argparse.Namespace(**data))


CONFIGS = {"rescaled": dict(rescaled=True), "logit": dict(logit_transform=True), "none": {}}


def _images(n=3, h=5, w=7, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, (n, h, w, c)).astype(np.float32)
    x[0, 0, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255][:c]  # exact rounding ties
    return x


@pytest.mark.parametrize("c", [1, 3])
def test_save_image_pixels_equal_jax(tmp_path, c):
    x = _images(c=c)[1]
    jimg.save_image(x, str(tmp_path / "j.png"))
    images.save_image(x, str(tmp_path / "t.png"))
    np.testing.assert_array_equal(_pixels(tmp_path / "t.png"), _pixels(tmp_path / "j.png"))
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "t.png"))[..., 0 if c == 1 else slice(None)],
                                  _pixels(tmp_path / "j.png"))


@pytest.mark.parametrize("nrow", [None, 2, 5])
def test_save_image_grid_pixels_equal_jax(tmp_path, nrow):
    x = _images(n=5)
    jimg.save_image_grid(x, str(tmp_path / "j.png"), nrow=nrow)
    images.save_image_grid(x, str(tmp_path / "t.png"), nrow=nrow)
    np.testing.assert_array_equal(_pixels(tmp_path / "t.png"), _pixels(tmp_path / "j.png"))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_write_png_batch_pixels_equal_jax(tmp_path, dtype):
    """`<start + i>.png` files, float [0, 1] input quantized, uint8 passed as it is."""
    x = _images(n=6, h=8, w=8)
    if dtype == "uint8":
        x = images.to_uint8(x)
    assert images.write_png_batch(x, str(tmp_path / "t"), 10, threads=3) == 6
    assert j_write_png_batch(x, str(tmp_path / "j"), 10) == 6
    for i in range(10, 16):
        np.testing.assert_array_equal(_pixels(tmp_path / "t" / f"{i}.png"), _pixels(tmp_path / "j" / f"{i}.png"))
    assert not list((tmp_path / "t").glob("*.tmp"))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_round_trip(c):
    img = np.random.default_rng(c).integers(0, 256, (9, 4, c), dtype=np.uint8)
    png = images.encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))).reshape(9, 4, c), img)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_transforms_equal_jax(cfg):
    """`data_transform` and `inverse_data_transform` (float) and the uint8
    inverse, against JAX's numpy transforms and its jitted uint8 function."""
    config = _config(**CONFIGS[cfg])
    x = _images(n=4, h=6, w=6)
    xm = np.clip(x, 0.01, 0.99) if cfg == "logit" else x
    np.testing.assert_allclose(tf.data_transform(config, torch.from_numpy(xm)).numpy(), jtf.data_transform(config, xm),
                               rtol=1e-6, atol=1e-6)
    y = np.random.default_rng(1).standard_normal((4, 6, 6, 3)).astype(np.float32) * 1.5
    np.testing.assert_allclose(tf.inverse_data_transform(config, torch.from_numpy(y)).numpy(),
                               jtf.inverse_data_transform(config, y), rtol=1e-6, atol=1e-7)
    got = tf.inverse_transform_uint8(config, torch.from_numpy(y))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtf.inverse_transform_uint8_fn(config)(jnp.asarray(y))))
    # the bulk path's pixels are the sample path's: uint8 on the device == float images through save_image
    np.testing.assert_array_equal(got.numpy(), images.to_uint8(tf.inverse_data_transform(config, torch.from_numpy(y))
                                                               .numpy()))


def test_dequantization_draws_from_the_generator():
    config = _config(rescaled=True, uniform_dequantization=True)
    x = torch.from_numpy(_images(n=2))
    with pytest.raises(ValueError, match="generator"):
        tf.data_transform(config, x)
    a = tf.data_transform(config, x, torch.Generator().manual_seed(1))
    assert torch.equal(a, tf.data_transform(config, x, torch.Generator().manual_seed(1)))
    assert not torch.equal(a, tf.data_transform(_config(rescaled=True), x))
