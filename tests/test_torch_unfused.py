"""PyTorch port vs the JAX package: the serving paths off the fused chains.

A narrow toy (32 and 64 channels, W4A8) whose convs the int8 fold does not
all cover: no resblock is fused (conv1 of 32 input channels is off the fold,
64 output channels are off the 128 grid), so every block runs JAX's unfused
chain (plain GroupNorm, K1 in int32 mode where the fold covers a conv, the
fake-quant float conv elsewhere); the 8x8 attention and conv_out are
fake-quant, the 4x4 attention (C = 64, off K3's grid) is composed around the
float32 core, the downsample is the fake-quant stride-2 conv.  And
`resamp_with_conv=False` (2x2 average down, nearest up, no conv) in the FP
forward and served.  Both at the float32 residual stream, on seeded ranges
and JAX's fold, as tests/test_torch_f32_stream.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.models import unet_apply as j_unet_apply
from attentiondm_tpu_torch.models.unet import avg_pool2, unet_apply
from attentiondm_tpu_torch.ops import checks
from test_torch_f32_stream import F32, TOY, _inputs, _jax_sample, _jax_step, _model, _rel, _sampler, _step, k1_modes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NARROW = dict(TOY, ch=32)
NO_RESAMP = dict(TOY, resamp_with_conv=False)


@pytest.fixture(scope="module")
def chain():
    """Both toys, JAX's serving step on each, its 2-step sampler on the
    narrow one and its FP forward on the one without resampling convs."""
    x, t = _inputs()
    narrow, no_resamp = _model(NARROW, 1), _model(NO_RESAMP, 2)
    return dict(narrow=narrow, no_resamp=no_resamp, x=x, t=t,
                eps={"narrow": _jax_step(narrow, x, t, **F32), "no_resamp": _jax_step(no_resamp, x, t, **F32)},
                sample=_jax_sample(narrow, x, **F32),
                fp=np.asarray(j_unet_apply(no_resamp["jparams"], no_resamp["jcfg"], jnp.asarray(x), jnp.asarray(t))))


# Mean relative error against JAX, measured: the step 8.27e-3 (JAX's step runs op by op; its jitted sampler
# reduces the unfused chain's GroupNorms in another order, and an int8 code on a rounding tie goes the other
# way), the 2-step sampler 1.45e-7; bounded at about twice and four times that.
NARROW_STEP_BOUND = 1.7e-2
NARROW_SAMPLER_BOUND = 5.8e-7


def test_uncovered_step_matches_jax(chain):
    m = chain["narrow"]
    assert not any(checks.fused_block(cin, cout) for cin, cout in ((32, 32), (32, 64), (64, 64), (128, 64)))
    eps = _step(m, chain["x"], chain["t"], **F32)
    assert torch.isfinite(eps).all()
    rel = _rel(eps.numpy(), chain["eps"]["narrow"])
    assert rel < NARROW_STEP_BOUND, rel


def test_uncovered_sampler_matches_jax(chain):
    out = _sampler(chain["narrow"], **F32)(torch.from_numpy(chain["x"]))
    assert torch.isfinite(out).all()
    rel = _rel(out.numpy(), chain["sample"])
    assert rel < NARROW_SAMPLER_BOUND, rel


def test_uncovered_launch_plan_matches_the_forward(chain):
    """`conv_plan` / `expected_launches` on the narrow toy: only the convs
    the fold covers, each in int32 mode (3x3: K13; the 4x4 attention's four
    projections: K5), no epilogue kernel, no K3, no K7 or K12 site; K4 at
    the composed attention's three-output entry alone (no block is fused)."""
    m = chain["narrow"]
    k1, epi = k1_modes(lambda: _step(m, chain["x"], chain["t"], **F32))
    plan, k2, k6, k3, composed = checks.conv_plan(m["cfg"])
    assert k1 == sorted(((k, s, mode) for _n, _H, _Cp, _Np, k, s, mode in plan), key=str)
    assert not epi and not k2 and not k6 and not k3 and [c[0] for c in composed] == ["mid.attn_1"]
    assert all(mode == torch.int32 for *_, mode in k1)
    counts = checks.expected_launches(m["cfg"], 1, 2, **F32, entry_pallas=True, boundary_fusion=True,
                                      resblock_pallas="all")
    assert counts["K5"] == sum(1 for c in k1 if c[0] == 1) == 8  # the 4x4 attention's projections, 4 shortcuts
    assert counts["K13"] == sum(1 for c in k1 if c[0] == 3) and counts["K2"] + counts["K3"] == 0
    assert (counts["K4"], counts["K7"], counts["K12"]) == (1, 0, 0)
    assert [site for site, *_ in checks.lever_plan(m["cfg"], 2)["K4"]] == ["mid.attn_1"]
    assert checks.gn_refused(m["cfg"], 2, entry_pallas=True, boundary_fusion=True, resblock_pallas="all") == []


def test_no_resamp_conv_matches_jax(chain):
    """`resamp_with_conv=False`: no resampling conv in the params or the fold,
    the FP forward (2x2 average down, nearest up) and the served step
    against JAX's."""
    m = chain["no_resamp"]
    assert m["params"]["down"][0]["downsample"] == {} and m["params"]["up"][1]["upsample"] == {}
    assert not any("sample" in name for name in m["runtime"])
    fp = unet_apply(m["params"], m["cfg"], torch.from_numpy(chain["x"]), torch.from_numpy(chain["t"]))
    # measured 2.59e-6 (float convs and GroupNorm sums in another order), bounded at 1e-5
    np.testing.assert_allclose(fp.numpy(), chain["fp"], rtol=0, atol=1e-5)
    eps = _step(m, chain["x"], chain["t"], **F32)
    np.testing.assert_array_equal(eps.numpy(), chain["eps"]["no_resamp"])


def test_avg_pool2_is_jax_reduce_window():
    """The 2x2 average sums each window in JAX's order: bit-equal to
    `reduce_window` / 4 on values where the order shows."""
    import jax

    x = np.random.default_rng(3).standard_normal((2, 8, 6, 5)).astype(np.float32) * np.float32(1e4) ** \
        np.random.default_rng(4).integers(-1, 2, (2, 8, 6, 5)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") / 4.0
    np.testing.assert_array_equal(avg_pool2(torch.from_numpy(x)).numpy(), np.asarray(want))
