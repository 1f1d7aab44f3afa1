"""PyTorch port vs the JAX package: FID (`eval/fid.py`) and the PNG reader
it scores folders with (`utils/images.read_png`, `to_rgb`).

tests/test_fid.py's closed forms and statistics on the port; the port's
Frechet functions against JAX's on the same float64 inputs (1e-10
relative); `sharded_statistics` (float32 sums of f and f f^T) against the
direct statistics at test_fid's bounds (mu rtol 1e-5, sigma rtol 1e-4 /
atol 1e-6); `.npz` statistics written by either stack read by the other;
the PNG reader against PIL's decode on files of every row filter and
colour type; the CLI's --save-stats round trip."""
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from attentiondm_tpu.eval import fid as jfid
from attentiondm_tpu_torch.eval import (
    calculate_activation_statistics,
    calculate_fid_given_paths,
    calculate_frechet_distance,
    compute_statistics_of_path,
    save_fid_stats,
)
from attentiondm_tpu_torch.eval import fid
from attentiondm_tpu_torch.eval.fid import frechet_smoke_safe, sharded_statistics
from attentiondm_tpu_torch.utils import images


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mean_pool(x):
    """A stand-in feature extractor (the reference mocks InceptionV3 the same way)."""
    return x.reshape(x.shape[0], -1, 3).mean(axis=1)


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T + np.eye(d)


def test_frechet_equal_gaussians_is_zero():
    mu = np.random.default_rng(0).normal(size=16)
    sigma = _spd(np.random.default_rng(1), 16)
    assert calculate_frechet_distance(mu, sigma, mu, sigma) == pytest.approx(0.0, abs=1e-4)


def test_frechet_equal_cov_is_mean_distance():
    rng = np.random.default_rng(2)
    mu1, mu2 = rng.normal(size=8), rng.normal(size=8)
    sigma = _spd(rng, 8)
    assert calculate_frechet_distance(mu1, sigma, mu2, sigma) == pytest.approx(float(np.sum((mu1 - mu2) ** 2)),
                                                                               rel=1e-4)


def test_frechet_diagonal_closed_form():
    """Diagonal Gaussians: |mu1 - mu2|^2 + sum (sqrt(s1) - sqrt(s2))^2."""
    s1, s2 = np.diag([1.0, 2.0, 3.0, 4.0]), np.diag([4.0, 3.0, 2.0, 1.0])
    expect = 4.0 + np.sum((np.sqrt(np.diag(s1)) - np.sqrt(np.diag(s2))) ** 2)
    assert calculate_frechet_distance(np.zeros(4), s1, np.ones(4), s2) == pytest.approx(expect, rel=1e-5)


@pytest.mark.parametrize("n1", [12, 40])
def test_frechet_functions_match_jax(n1):
    """Both Frechet forms (the eigenvalue form below D samples, sqrtm at or
    above) equal JAX's on the same float64 statistics to 1e-10."""
    rng = np.random.default_rng(n1)
    a, b = rng.normal(size=(n1, 32)), rng.normal(size=(50, 32)) * 1.3 + 0.2
    m1, s1, m2, s2 = a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)
    for got, want in ((calculate_frechet_distance(m1, s1, m2, s2), jfid.calculate_frechet_distance(m1, s1, m2, s2)),
                      (frechet_smoke_safe(m1, s1, m2, s2, n1), jfid.frechet_smoke_safe(m1, s1, m2, s2, n1))):
        assert np.isfinite(got) and abs(got - want) <= 1e-10 * abs(want)


def test_activation_statistics_exact():
    imgs = np.random.default_rng(3).random((10, 4, 4, 3)).astype(np.float32)
    mu, sigma = calculate_activation_statistics([imgs], _mean_pool, device="cpu")
    feats = imgs.reshape(10, -1, 3).mean(axis=1)
    np.testing.assert_allclose(mu, feats.mean(0), rtol=1e-5)
    np.testing.assert_allclose(sigma, np.cov(feats, rowvar=False), rtol=1e-4)


@pytest.mark.parametrize("streamed", [False, True])
def test_sharded_statistics_matches_direct(streamed):
    """On-device float32 sums against the host statistics, over one array
    (sliced into batches) or a stream of batches; a mesh raises."""
    imgs = np.random.default_rng(5).random((32, 4, 4, 3)).astype(np.float32)
    mu_d, sig_d = calculate_activation_statistics([imgs], _mean_pool, device="cpu")
    src = (torch.from_numpy(imgs[i:i + 8]) for i in range(0, 32, 8)) if streamed else imgs
    mu_s, sig_s = sharded_statistics(src, _mean_pool, batch_size=16, device="cpu")
    np.testing.assert_allclose(mu_s, mu_d, rtol=1e-5)
    np.testing.assert_allclose(sig_s, sig_d, rtol=1e-4, atol=1e-6)
    j_mu, j_sig = jfid.sharded_statistics(imgs, _mean_pool, batch_size=16)
    assert mu_s.dtype == np.asarray(j_mu).dtype == np.float32 and sig_s.dtype == np.asarray(j_sig).dtype
    with pytest.raises(NotImplementedError, match="item 9"):
        sharded_statistics(imgs, _mean_pool, mesh=object(), device="cpu")


def _write_pngs(d, n, seed, size=8):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(d / f"{i}.png")


def test_fid_paths_and_stats_roundtrip(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    _write_pngs(d1, 8, 4)
    _write_pngs(d2, 8, 5)
    fid_ab = calculate_fid_given_paths([str(d1), str(d2)], _mean_pool, batch_size=4, device="cpu")
    assert np.isfinite(fid_ab) and fid_ab >= 0
    assert calculate_fid_given_paths([str(d1), str(d1)], _mean_pool, 4, "cpu") == pytest.approx(0.0, abs=1e-4)
    stats = tmp_path / "stats.npz"
    save_fid_stats([str(d1), str(stats)], _mean_pool, batch_size=4, device="cpu")
    assert calculate_fid_given_paths([str(stats), str(d2)], _mean_pool, 4, "cpu") == pytest.approx(fid_ab, rel=1e-4)
    # the folder's statistics equal JAX's (its images decoded by PIL, the port's by read_png)
    mu, sigma = compute_statistics_of_path(str(d1), _mean_pool, 4, "cpu")
    j_mu, j_sigma = jfid.compute_statistics_of_path(str(d1), _mean_pool, 4)
    np.testing.assert_allclose(mu, j_mu, rtol=1e-6)
    np.testing.assert_allclose(sigma, j_sigma, rtol=1e-5, atol=1e-5 * np.abs(j_sigma).max())


def test_npz_stats_cross_read(tmp_path):
    """Statistics saved by either stack read back equal by the other."""
    d = tmp_path / "imgs"
    _write_pngs(d, 6, 6)
    save_fid_stats([str(d), str(tmp_path / "port.npz")], _mean_pool, 3, "cpu")
    jfid.save_fid_stats([str(d), str(tmp_path / "jax.npz")], _mean_pool, 3)
    read = {}
    for name in ("port.npz", "jax.npz"):
        mu, sigma = compute_statistics_of_path(str(tmp_path / name), _mean_pool, device="cpu")
        j_mu, j_sigma = jfid.compute_statistics_of_path(str(tmp_path / name), _mean_pool)
        assert np.array_equal(mu, j_mu) and np.array_equal(sigma, j_sigma) and sigma.dtype == np.float64
        read[name] = mu, sigma
    # the two stacks' statistics: features equal up to float32 summation order
    (mu, sigma), (j_mu, j_sigma) = read["port.npz"], read["jax.npz"]
    np.testing.assert_allclose(mu, j_mu, rtol=1e-6)
    np.testing.assert_allclose(sigma, j_sigma, rtol=1e-5, atol=1e-5 * np.abs(j_sigma).max())


def test_fid_invalid_path():
    with pytest.raises(RuntimeError, match="Invalid path"):
        calculate_fid_given_paths(["/nope/a", "/nope/b"], _mean_pool, device="cpu")


def test_other_extensions_need_pil(tmp_path, monkeypatch):
    """A .jpg decodes through PIL; where PIL is missing the error names the file."""
    d = tmp_path / "j"
    d.mkdir()
    Image.fromarray(np.full((4, 4, 3), 200, np.uint8)).save(d / "a.jpg", quality=100)
    (x,) = list(fid._iter_image_dir(str(d), 4))
    assert x.shape == (1, 4, 4, 3) and abs(float(x.mean()) - 200 / 255) < 0.02
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"a\.jpg.*PIL"):
        list(fid._iter_image_dir(str(d), 4))


# ---------------------------------------------------------------------------
# the PNG reader
# ---------------------------------------------------------------------------


def _filtered_png(img, kind):
    """PNG bytes of a uint8 [H, W, C] image with every row under filter `kind` (0 to 4)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        cur, up = x[y], x[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - up
        elif kind == 3:
            f = cur - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    chunk = images._chunk
    return (images._SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _gradient(h=9, w=13, c=3, seed=0):
    """An image with smooth and noisy parts, so that each filter has work to do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 17 + xx * 29)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 60, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_read_png_each_filter_equals_pil(tmp_path, kind, c):
    """Rows under each of the five filters, grey / grey + alpha / RGB / RGBA:
    `read_png` gives the stored pixels, `to_rgb` PIL's `.convert("RGB")`."""
    img = _gradient(c=c, seed=kind)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, kind))
    got = images.read_png(str(path))
    pil = Image.open(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got[..., 0] if c == 1 else got, np.asarray(pil))
    np.testing.assert_array_equal(images.to_rgb(got), np.asarray(pil.convert("RGB")))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_read_png_of_pil_files(tmp_path, mode):
    """Files PIL writes (its encoder picks a filter per row) decode to PIL's pixels."""
    img = Image.fromarray(_gradient(h=24, w=31, c=3, seed=9)).convert(mode)
    path = tmp_path / "p.png"
    img.save(path)
    raw = zlib.decompress(path.read_bytes()[8:].split(b"IDAT", 1)[1][:-4])
    got = images.read_png(str(path))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(images.to_rgb(got), want)
    if mode == "RGB":  # PIL chose several row filters for this image
        stride = 1 + 31 * 3
        assert len({raw[y * stride] for y in range(24)}) > 1


def test_cli_save_stats_round_trip(tmp_path, capsys):
    """`python -m attentiondm_tpu_torch.eval.fid folder stats.npz --save-stats`,
    then the FID between the folder and its own statistics (0 up to sqrtm's
    rounding), on the seeded random Inception."""
    d = tmp_path / "imgs"
    _write_pngs(d, 6, 7, size=16)
    stats = str(tmp_path / "s.npz")
    assert fid.main([str(d), stats, "--save-stats", "--batch-size", "4", "--device", "cpu"]) == 0
    with np.load(stats) as f:
        mu, sigma = f["mu"], f["sigma"]
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048) and np.isfinite(sigma).all()
    capsys.readouterr()
    assert fid.main([str(d), stats, "--batch-size", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "WARNING: no --inception-weights" in out
    value = float(out.strip().splitlines()[-1].split()[-1])
    assert abs(value) < 1e-3


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    """Without a device named the statistics run on the CUDA device, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calculate_activation_statistics([np.zeros((2, 4, 4, 3), np.float32)], _mean_pool)
