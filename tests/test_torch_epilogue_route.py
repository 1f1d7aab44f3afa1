"""PyTorch port vs the JAX package: the serving epilogue (conv1 -> +temb ->
GroupNorm -> swish -> int8) at shapes over the TPU's whole-image budget and
off the blocked kernel's grid (N % 128 or HW % 8), where JAX's dispatcher
runs its XLA reference (`epilogue_gn_swish_quant_reference`, the model's
two-pass variance).  The port routes them to K2 (`ops.fused_gn.epilogue_route`;
on the CPU its plain version, `epilogue_gn_swish_quant_ref`), which sums
E[x^2] - mu^2 in the windowed order: held to JAX's codes at K2's tolerance
(`ops.checks`: at most 1 LSB on at most 0.1% of the codes), with the share
measured printed.  Shapes on K6's grid or within the budget keep their
route; N off K2's plans (1032) still raises, naming the shape; the
launch plans count such a site as a K2 launch, not a refusal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentiondm_tpu.ops.fused_gn import epilogue_gn_swish_quant as j_epilogue_gn_swish_quant
from attentiondm_tpu_torch.models.unet import UNetConfig
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops.fused_gn import (
    epilogue_gn_swish_quant,
    epilogue_gn_swish_quant_ref,
    epilogue_gn_swish_quant_whole,
    epilogue_route,
)
from test_torch_kernels import _jax_route, _k2_inputs, _torch_args


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_off_grid_over_the_budget_takes_k2_with_jax_codes(monkeypatch, dtype, capsys):
    """105 x 105 (HW % 8 = 1) at N = 128, batch 2: JAX takes its XLA
    reference, the port K2, whose codes are JAX's within K2's tolerance."""
    shape = (2, 105, 105, 128)
    assert _jax_route(monkeypatch, shape, getattr(jnp, dtype)) == "xla"
    monkeypatch.undo()  # JAX's dispatcher back, to compute its codes
    assert epilogue_route(shape, getattr(torch, dtype)) == "K2"
    rng = np.random.default_rng(105 + len(dtype))
    args = _k2_inputs(rng, 105 * 105, 128, dtype)
    targs = _torch_args(args)
    before = epilogue_gn_swish_quant_whole.launches
    got = epilogue_gn_swish_quant(*targs, 8)
    assert epilogue_gn_swish_quant_whole.launches == before  # CPU tensors: the plain version, no launch
    assert torch.equal(got, epilogue_gn_swish_quant_ref(*targs, 8))
    want = torch.from_numpy(np.array(j_epilogue_gn_swish_quant(*map(jnp.asarray, args), 8)))
    fig = checks.compare("K2", got, want)
    with capsys.disabled():
        print(f"\n[epilogue off-grid {dtype}] {shape}: max_abs_err {fig['max_abs_err']} LSB, "
              f"codes off {fig['frac']:.3g}")
    assert fig["ok"], fig


@pytest.mark.parametrize("shape,dtype,jax_route,want", [
    ((2, 64, 64, 128), "bfloat16", "K2", "K2"),  # within the budget
    ((2, 32, 32, 96), "int32", "K2", "K2"),  # within the budget, off K6's grid
    ((1, 128, 128, 128), "bfloat16", "K6", "K6"),  # over the budget, on K6's grid
    ((1, 64, 64, 256), "int32", "K6", "K6"),
    ((2, 105, 105, 128), "bfloat16", "xla", "K2"),  # over the budget, off K6's grid
    ((1, 100, 100, 96), "int32", "xla", "K2"),
])
def test_routes_on_the_grid_and_within_the_budget_stay(monkeypatch, shape, dtype, jax_route, want):
    """JAX's whole-image and blocked shapes keep their kernels; only JAX's
    XLA-reference shapes change, to K2."""
    assert _jax_route(monkeypatch, shape, getattr(jnp, dtype)) == jax_route
    assert epilogue_route(shape, getattr(torch, dtype)) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "int32"])
def test_n_off_k2s_plans_still_raises(dtype):
    """N = 1032 (over K2's 1024 channels) over the budget: no kernel takes
    it, and the route names the shape."""
    with pytest.raises(NotImplementedError, match=r"B=2, HW=11025, N=1032"):
        epilogue_route((2, 105, 105, 1032), getattr(torch, dtype))
    dot = torch.zeros((2, 105, 105, 1032), dtype=getattr(torch, dtype))
    v = torch.ones(1032)
    with pytest.raises(NotImplementedError, match=r"N=1032"):
        epilogue_gn_swish_quant(dot, v, v, torch.zeros((2, 1032)), v, v, v, v, 8)


def test_plans_count_the_site_as_a_k2_launch():
    """A one-level UNet at 105 x 105: every fused resblock's conv1 epilogue
    is over the budget and off K6's grid.  `expected_launches` counts each
    as a K2 launch, `gn_refused` refuses none, in both dot forms."""
    cfg = UNetConfig(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(), resolution=105, dropout=0.0)
    for dot_bf16 in (True, False):
        _k1, k2, k6, _k3, _composed = checks.conv_plan(cfg, dot_bf16=dot_bf16)
        assert k6 == [] and k2 == [(105 * 105, 128)] * 5  # down 1, mid 2, up 2
        counts = checks.expected_launches(cfg, 2, 2, dot_bf16=dot_bf16)
        assert counts["K2"] == 10 and counts["K6"] == 0
        assert checks.gn_refused(cfg, 2, dot_bf16=dot_bf16) == []
