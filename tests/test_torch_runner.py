"""PyTorch port vs the JAX package: the runner's sampling half
(`attentiondm_tpu_torch.runners.Diffusion`, on the CPU) on
`tests/test_runner.py`'s tiny config (ch 32, 16x16, 20 diffusion steps).

Both runners load one checkpoint that JAX wrote.  The port's random draws
all go through `Diffusion.randomness`; these tests replace it with JAX's own
draws (the keys JAX's `sample()` derives from --seed), so the two runners
sample from the same noise and their PNGs compare pixel by pixel."""
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from attentiondm_tpu import checkpoint as jckpt
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.runners import Diffusion as JDiffusion
from attentiondm_tpu_torch.data.transforms import inverse_data_transform
from attentiondm_tpu_torch.quant.int8_serving import serving_ddim_sampler
from attentiondm_tpu_torch.runners.diffusion import Diffusion
from attentiondm_tpu_torch.utils.images import read_png, to_uint8
from test_runner import make_args, tiny_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per xdist worker keeps OpenMP from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 3  # --timesteps


def _args(tmp, name, **kw):
    base = dict(timesteps=STEPS, num_samples=8, execution="fake_quant", compute_dtype="float32", normgroup=0,
                attn_variant="ddim", mixed_precision_attention=False, batch_size=None, attn_int8=False,
                step_chunk=None, superbatch=None, shared_fold=False, pack_int4=False, weight_opt="gptq",
                weight_refine="off", adaround_iters=20, stage2_mode="reference", stage2_lr=0.02, calib_cache=None,
                calib_epochs=1, fid_stats=None, image_folder=os.path.join(str(tmp), name))
    base.update(kw)
    return make_args(tmp, **base)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX param tree of the tiny config, saved with JAX's `save_checkpoint`."""
    path = str(tmp_path_factory.mktemp("ckpt") / "params.npz")
    jckpt.save_checkpoint(path, j_unet_init(jax.random.PRNGKey(11), JConfig(
        ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16, dropout=0.0)))
    return path


def split_chain(key, shape, steps):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return torch.from_numpy(np.stack(out))


def jax_randomness(runner):
    """`Diffusion.randomness` with JAX's draws: the keys JAX's runner takes
    for each stream, and the split chain its sampler draws per step."""
    seed = int(runner.args.seed)

    def randomness(stream, shape=None, index=0):
        steps = len(runner.make_seq())
        if stream == "sample":
            _, key = jax.random.split(jax.random.PRNGKey(seed))
            x, chain = jax.random.normal(key, shape), split_chain(key, shape, steps)
        elif stream == "calibration":  # the trajectory's sampler takes no key: PRNGKey(0)
            x = jax.random.normal(jax.random.PRNGKey(seed + 77), shape)
            chain = split_chain(jax.random.PRNGKey(0), shape, steps)
        elif stream == "calibration t":
            x, chain = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(seed + 77), 1), shape), None
        elif stream == "interpolation":
            k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
            one = (1,) + tuple(shape[1:])
            x = np.concatenate([jax.random.normal(k1, one), jax.random.normal(k2, one)])
            chain = split_chain(jax.random.PRNGKey(0), (11,) + tuple(shape[1:]), steps)
        else:
            raise AssertionError(f"no JAX draws for stream {stream!r}")
        return torch.from_numpy(np.array(x)), {"noise": chain}

    return randomness


def _port_runner(args, jax_draws=True):
    r = Diffusion(args, tiny_config(None), device="cpu")
    if jax_draws:
        r.randomness = jax_randomness(r)
    return r


def _pixels(path):
    return np.asarray(Image.open(path)).astype(np.int32)


def _compare_folders(got_dir, want_dir, names):
    """(max |pixel difference|, mean |difference| / mean pixel) over the named PNGs."""
    worst, diff, total = 0, 0.0, 0.0
    for nm in names:
        a, b = _pixels(os.path.join(got_dir, nm)), _pixels(os.path.join(want_dir, nm))
        assert a.shape == b.shape, nm
        worst = max(worst, int(np.abs(a - b).max()))
        diff += float(np.abs(a - b).sum())
        total += float(b.sum())
    return worst, diff / total


SAMPLES = [f"sample_{i}.png" for i in range(8)] + ["grid.png"]


@pytest.mark.parametrize("mode", ["fp32", "fp32_ddpm", "fake_quant"])
def test_sample_matches_jax_runner(tmp_path, ckpt, mode):
    """`sample()`'s `sample_<i>.png` and grid against JAX's runner on the same
    checkpoint and draws.  `--fp32` (DDIM, and DDPM with `--sample_type
    ddpm_noisy`): measured pixel-equal; held to one step of 255 (a float32
    image 1e-6 off, as the two stacks' convs are, rounds the other way at a
    .5 tie).  Fake-quant W4A8 (stage-1 calibration on the teacher's
    trajectory, then the fake-quant sampler): measured max 2 steps, mean
    1.2e-3 of the pixel mean (activation codes on rounding ties flip); held
    to 4x: a mean of 4.9e-3 and no pixel off by more than 8."""
    kw = dict(fp32=True) if mode.startswith("fp32") else dict(bitwidth=4, a_bitwidth=8)
    if mode == "fp32_ddpm":
        kw["sample_type"] = "ddpm_noisy"
    args_j = _args(tmp_path, "jax", ckpt_path=ckpt, **kw)
    JDiffusion(args_j, tiny_config(None)).sample()
    args_t = _args(tmp_path, "torch", ckpt_path=ckpt, **kw)
    _port_runner(args_t).sample()
    worst, mean = _compare_folders(args_t.image_folder, args_j.image_folder, SAMPLES)
    if mode.startswith("fp32"):
        assert worst <= 1, worst
    else:
        assert mean < 4.9e-3 and worst <= 8, (worst, mean)


def test_sequence_and_interpolation_match_jax(tmp_path, ckpt):
    """`--sequence` (a grid every max(1, S // 10) steps of the trajectory,
    then the samples) and `--interpolation` (slerp between two draws, 11
    points), `--fp32`, against JAX's files: measured pixel-equal, held to one
    pixel step, as the fp32 samples."""
    for flag, names in (("sequence", [f"seq_step{s}.png" for s in range(STEPS)] + SAMPLES),
                        ("interpolation", ["interpolation.png"])):
        args_j = _args(tmp_path, f"jax_{flag}", ckpt_path=ckpt, fp32=True, **{flag: True})
        JDiffusion(args_j, tiny_config(None)).sample()
        args_t = _args(tmp_path, f"torch_{flag}", ckpt_path=ckpt, fp32=True, **{flag: True})
        _port_runner(args_t).sample()
        assert sorted(os.listdir(args_t.image_folder)) == sorted(os.listdir(args_j.image_folder))
        worst, _ = _compare_folders(args_t.image_folder, args_j.image_folder, names)
        assert worst <= 1, (flag, worst)


def _seeded_draws(runner):
    """Seeded numpy draws for every stream (the serving checks need no JAX)."""
    def randomness(stream, shape=None, index=0):
        rng = np.random.default_rng([index, len(stream)])
        steps = len(runner.make_seq())
        x = None if shape is None else torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        chain = None if shape is None else torch.from_numpy(rng.standard_normal((steps,) + tuple(shape))
                                                            .astype(np.float32))
        return x, {"noise": chain}

    return randomness


@pytest.mark.parametrize("kind", ["ddim", "ddpm_noisy", "eta"])
def test_serving_sample_is_the_direct_sampler(tmp_path, ckpt, kind):
    """`--execution serving`: the runner's images are to the bit those of a
    `serving_ddim_sampler` built directly from the runner's calibration and
    flags and run on the same draws (DDIM, `--sample_type ddpm_noisy`,
    `--eta 0.5`)."""
    kw = dict(sample_type="ddpm_noisy") if kind == "ddpm_noisy" else dict(eta=0.5) if kind == "eta" else {}
    args = _args(tmp_path, "serving", ckpt_path=ckpt, execution="serving", bitwidth=4, a_bitwidth=8,
                 weight_opt="biascorr", **kw)
    r = Diffusion(args, tiny_config(None), device="cpu")
    r.randomness = _seeded_draws(r)
    r.sample()
    srv = r.serving
    assert srv["kwargs"]["update"] == ("ddpm" if kind == "ddpm_noisy" else "ddim")
    assert srv["kwargs"]["eta"] == (0.5 if kind == "eta" else 0.0)
    assert srv["kwargs"]["residual_dtype"] == torch.float32 and srv["kwargs"]["weight_extras"]
    sampler = serving_ddim_sampler(srv["qunet"], srv["params"], srv["qstates"], srv["seq"], r.betas, **srv["kwargs"])
    x, kw_draws = r.randomness("sample", (8, 16, 16, 3))
    out = sampler(x, **kw_draws)
    want = to_uint8(inverse_data_transform(r.config, out).numpy())
    for i in range(8):
        np.testing.assert_array_equal(read_png(os.path.join(args.image_folder, f"sample_{i}.png")), want[i])


def test_fid_resume_is_byte_identical(tmp_path, ckpt):
    """`--fid`: 20 images in batches of 8 (the last batch generates only 4),
    each batch from its own stream; ids 9 and 15.. deleted, the run resumes
    at 8 (the first hole aligned down to the batch grid) and every file
    comes back byte-identical.  The resumed run reuses the calibration cache
    the first one wrote."""
    cache = str(tmp_path / "calib.npz")
    args = _args(tmp_path, "fid", ckpt_path=ckpt, execution="serving", bitwidth=4, a_bitwidth=8, fid=True,
                 num_samples=20, weight_opt="biascorr", calib_cache=cache)
    r = _port_runner(args, jax_draws=False)
    r.sample()
    assert r.fid_images == 20 and os.path.exists(cache) and "calibration" in r.timings
    files = {f: open(os.path.join(args.image_folder, f), "rb").read() for f in os.listdir(args.image_folder)}
    assert sorted(files) == sorted(f"{i}.png" for i in range(20))
    for i in [9] + list(range(15, 20)):
        os.remove(os.path.join(args.image_folder, f"{i}.png"))
    r2 = _port_runner(args, jax_draws=False)
    r2.sample()
    assert r2.fid_images == 12 and "calibration" not in r2.timings and "calibration cache" in r2.timings
    again = {f: open(os.path.join(args.image_folder, f), "rb").read() for f in os.listdir(args.image_folder)}
    assert again == files


def test_calib_cache_round_trip(tmp_path, ckpt):
    """`--calib_cache auto` (<log_path>/calib_cache.npz): the second run loads
    the first one's calibration instead of calibrating, and samples the same
    images; the cache also loads in JAX's runner (format 3, JAX's header)."""
    kw = dict(ckpt_path=ckpt, bitwidth=4, a_bitwidth=8, calib_cache="auto")
    first = _port_runner(_args(tmp_path, "c1", **kw))
    first.sample()
    assert os.path.exists(os.path.join(first.args.log_path, "calib_cache.npz"))
    second = _port_runner(_args(tmp_path, "c2", **kw))
    second.sample()
    assert "calibration" not in second.timings and "teacher" not in second.timings
    worst, _ = _compare_folders(second.args.image_folder, first.args.image_folder, SAMPLES)
    assert worst == 0
    from attentiondm_tpu.quant.calib_cache import load_calibration as j_load

    j_runner = JDiffusion(_args(tmp_path, "c3", **kw), tiny_config(None))
    assert j_load(os.path.join(first.args.log_path, "calib_cache.npz"), j_runner.args, j_runner.make_seq(),
                  model_sig=str(j_runner.ucfg)) is not None


def test_unported_entry_points_raise(tmp_path):
    """train() and test() on a CelebA set that is not there raise
    FileNotFoundError naming its folder (nothing is downloaded), and on a
    dataset JAX does not read NotImplementedError; no flag is ignored.
    train() and test() themselves are ported
    (tests/test_torch_runner_train.py), and so is --fid_stats
    (tests/test_torch_fid_stats.py)."""
    r = _port_runner(_args(tmp_path, "x", fp32=True), jax_draws=False)
    r.config.data.dataset = "CELEBA"
    with pytest.raises(FileNotFoundError, match="celeba"):
        r.train()
    with pytest.raises(FileNotFoundError, match="celeba"):
        r.test()
    r.config.data.dataset = "MNIST"
    with pytest.raises(NotImplementedError, match="dataset MNIST"):
        r.train()
    with pytest.raises(NotImplementedError, match="dataset MNIST"):
        r.test()


def test_runner_needs_a_device_or_cpu(tmp_path, monkeypatch):
    """With no device named the runner takes the CUDA device, and raises
    where there is none; nothing falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Diffusion(_args(tmp_path, "y"), tiny_config(None))
    assert Diffusion(_args(tmp_path, "y"), tiny_config(None), device="cpu").device.type == "cpu"


def test_random_init_and_registry_lookup(tmp_path, monkeypatch):
    """Without a checkpoint the runner warns and takes seeded random weights
    (the same for the same --seed); --use_pretrained looks the registry name
    up locally and raises FileNotFoundError naming the md5 when it is absent."""
    r = _port_runner(_args(tmp_path, "z", fp32=True), jax_draws=False)
    a, b = r._load_params(), r._load_params()
    assert torch.equal(a["conv_in"]["kernel"], b["conv_in"]["kernel"])
    monkeypatch.setenv("ATTENTIONDM_CKPT_ROOT", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path))
    r.args.use_pretrained = True
    r.config.data.dataset = "CIFAR10"
    with pytest.raises(FileNotFoundError, match="1fa350b952534ae442b1d5235cce5cd3"):  # ema_cifar10 (config ema)
        r._load_params()
