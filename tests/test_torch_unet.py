"""PyTorch port vs the JAX package: FP UNet, schedule, DDIM sampler, layout
(attentiondm_tpu_torch.models / .diffusion / .ops.attention)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.diffusion import DiffusionSchedule as JSchedule
from attentiondm_tpu.diffusion import ddim_sample as j_ddim_sample
from attentiondm_tpu.diffusion import make_timestep_seq as j_make_seq
from attentiondm_tpu.models import UNetConfig as JConfig
from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu.models import unet_init as j_unet_init
from attentiondm_tpu.models.unet import group_norm as j_group_norm
from attentiondm_tpu.models.unet import iter_conv_layers as j_iter_conv_layers
from attentiondm_tpu.ops.attention import spatial_attention as j_spatial_attention
from attentiondm_tpu_torch.diffusion.sampling import ddim_sample, make_timestep_seq
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import (
    UNetConfig,
    count_params,
    exact_f32,
    from_jax_params,
    group_norm,
    iter_conv_layers,
    unet_apply,
    unet_init,
)
from attentiondm_tpu_torch.ops.attention import spatial_attention


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOY = dict(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=8, dropout=0.0)
REPO = Path(__file__).resolve().parent.parent


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def toy():
    params = j_unet_init(jax.random.PRNGKey(0), JConfig(**TOY))
    return JConfig(**TOY), params, from_jax_params(_np(params), device="cpu")


@pytest.mark.parametrize("cfg_kw", [TOY, {}], ids=["toy", "cifar10"])
def test_iter_conv_layers_lockstep(cfg_kw):
    """Same names, in channels and kernel sizes, in the same order."""
    assert list(iter_conv_layers(UNetConfig(**cfg_kw))) == list(j_iter_conv_layers(JConfig(**cfg_kw)))


def test_unet_apply_matches_jax(toy):
    jcfg, jparams, tparams = toy
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    want = np.asarray(j_unet_apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(t)))
    got = unet_apply(tparams, UNetConfig(**TOY), torch.from_numpy(x), torch.from_numpy(t)).numpy()
    # float32 both sides; only summation order differs (measured max abs 2.5e-6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_group_norm_and_attention_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 4, 4, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32), "bias": rng.standard_normal(64).astype(np.float32)}
    want = np.asarray(j_group_norm(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p)))
    got = group_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)  # f32 stats, same formula

    q, k, v = (rng.standard_normal((2, 64, 32)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = spatial_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_schedule_and_timestep_seq_match_jax():
    a = JSchedule.create("linear", 1e-4, 0.02, 1000)
    b = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")
    for f in ("betas", "alphas_cumprod", "logvar"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
    for steps, kind in ((10, "quad"), (100, "quad"), (7, "uniform"), (300, "uniform")):
        np.testing.assert_array_equal(make_timestep_seq(1000, steps, kind), j_make_seq(1000, steps, kind))


def test_ddim_sample_trajectory_matches_jax(toy):
    jcfg, jparams, tparams = toy
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 3)).astype(np.float32)
    seq = [0, 500]
    betas = JSchedule.create("linear", 1e-4, 0.02, 1000).betas
    xf_j, xs_j, x0_j = j_ddim_sample(lambda xt, t, i: j_unet_apply(jparams, jcfg, xt, t),
                                     jnp.asarray(x), seq, betas, keep_trajectory=True)
    cfg = UNetConfig(**TOY)
    xf, xs, x0 = ddim_sample(lambda xt, t, i: unet_apply(tparams, cfg, xt, t), torch.from_numpy(x), seq,
                             DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas, keep_trajectory=True)
    # two f32 UNet evaluations deep: 1e-4 as for one forward, both ways
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(x0.numpy(), np.asarray(x0_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xf.numpy(), np.asarray(xf_j), atol=1e-4, rtol=1e-4)


def test_unet_init_structure_and_size():
    """Seeded torch init: the JAX tree's structure and shapes, CIFAR-10 size."""
    p = unet_init(torch.Generator().manual_seed(0), UNetConfig(), "cpu")
    jshapes = jax.eval_shape(lambda: j_unet_init(jax.random.PRNGKey(0), JConfig()))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(p)) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jshapes)
    assert abs(count_params(p) - 35.75e6) < 0.01e6
    again = unet_init(torch.Generator().manual_seed(0), UNetConfig(), "cpu")
    assert torch.equal(p["conv_out"]["kernel"], again["conv_out"]["kernel"])


def test_port_imports_without_jax_triton_or_gpu():
    """The port never imports jax, attentiondm_tpu or triton, and imports
    on a machine with no nvcc and no GPU."""
    code = (
        "import sys\n"
        "import attentiondm_tpu_torch.quant.int8_serving, attentiondm_tpu_torch.quant.calibrate\n"
        "import attentiondm_tpu_torch.ops._build, attentiondm_tpu_torch.diffusion.sampling\n"
        "import attentiondm_tpu_torch.training, attentiondm_tpu_torch.runners.diffusion\n"
        "import attentiondm_tpu_torch.data.loader, attentiondm_tpu_torch.tools.train_synthetic\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'attentiondm_tpu', 'triton')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    for f in (REPO / "attentiondm_tpu_torch").rglob("*.py"):
        if "_build" in f.relative_to(REPO).parts:  # build outputs, not the package's sources
            continue
        src = f.read_text()
        assert "import jax" not in src and "from jax" not in src, f
        assert "attentiondm_tpu." not in src and "from attentiondm_tpu " not in src, f


@pytest.mark.parametrize("call", ["schedule", "eta", "flash"])
def test_unported_fp_options_raise(call):
    if call == "flash":  # ported: a long map takes the flash kernel's route (K11) instead of raising
        from attentiondm_tpu_torch.ops.attention import flash_attention_ref

        q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal((1, 1024, 128)).astype(np.float32))
                   for i in range(3))
        out = spatial_attention(q, k, v)
        assert torch.equal(out, flash_attention_ref(q, k, v)) and torch.isfinite(out).all()
        dense = torch.softmax(q @ k.transpose(1, 2) * 128 ** -0.5, dim=-1) @ v
        assert not torch.equal(out, dense) and torch.allclose(out, dense, atol=2e-5, rtol=2e-5)
        return
    if call == "eta":  # ported: eta > 0 draws from the generator it is given (tests/test_torch_ddpm.py), none raises
        sched = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu")
        with pytest.raises(ValueError, match="generator"):
            ddim_sample(lambda xt, t, i: xt, torch.zeros(1, 8, 8, 3), [0, 500], sched.betas, eta=0.5)
        out = ddim_sample(lambda xt, t, i: xt, torch.zeros(1, 8, 8, 3), [0, 500], sched.betas, eta=0.5,
                          generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out).all() and out.abs().sum() > 0
        return
    with pytest.raises(NotImplementedError):
        DiffusionSchedule.create("warmup", 1e-4, 0.02, 1000, device="cpu")  # a schedule no package has


def test_exact_f32_scopes_the_tf32_switches():
    """The float32 forwards turn TF32 off only while they run."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with exact_f32():
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
