"""The two attention cores the CUDA port runs on the tensor cores, held on the
CPU: K3's core (`fused_attention_block`, csrc/int8_attention.cu), whose f32
products run as 3xTF32 `mma`s, and the K8 / K9 / K10 core
(csrc/int8_attn_core.cu).

- A plain-torch emulation of the 3xTF32 product (each operand split into a
  TF32 high part and a TF32 remainder, rounded as `cvt.rna.tf32.f32` does)
  run through K3's plain core meets K3's tolerance against the f32 plain
  version and against JAX's `fused_attention_block` (Pallas, interpret mode)
  on the same numpy inputs.  The emulation lives here only.
- The Python launch geometry of both cores (`core_plan`, `int8_core_plan`)
  at every attention shape of the CIFAR-10, LSUN church and celeba-wide
  configurations and at the wrappers' limits.
- The sites a configuration sends off the kernels' widths, named before the
  sampler's first step (`ops.checks.attention_plan`'s "refused").
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from attentiondm_tpu.ops import int8_attention as j_i8
from attentiondm_tpu_torch.config import load_config
from attentiondm_tpu_torch.diffusion.schedules import DiffusionSchedule
from attentiondm_tpu_torch.models.unet import UNetConfig, unet_init
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops import int8_attention as ia
from attentiondm_tpu_torch.ops.precision import exact_f32
from attentiondm_tpu_torch.quant import int8_serving as srv
from attentiondm_tpu_torch.quant.qunet import QuantizedUNet


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 3xTF32, emulated
# ---------------------------------------------------------------------------


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) as `cvt.rna.tf32.f32` rounds: to
    nearest, ties away from zero, on the bit pattern; kept in an f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's `mma_3xtf32` computes it: hi = tf32(x), lo =
    tf32(x - hi), a_hi b_lo + a_lo b_hi + a_hi b_hi; each term's products are
    exact in f32 and accumulate in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    with exact_f32():
        return (ah @ bl + al @ bh) + ah @ bh


def _mm_1xtf32(a, b):
    with exact_f32():
        return _tf32(a) @ _tf32(b)


def _core_emulated(mm):
    """K3's plain core (`ia.attention_core_ref`) with both f32 products taken
    by `mm`; the int8 mode's logits stay the exact integer product."""

    def core(q, k, v, out_scale, out_zp, a_bit, *, scale, int8_core=False, logits=False):
        if int8_core:
            (qq, sq), (kq, sk) = ia._dyn_quant_i8(q), ia._dyn_quant_i8(k)
            lg = ia._int8_logits(qq, kq) * (sq * sk * scale)
        else:
            lg = mm(q, k.transpose(1, 2)) * scale
        e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        o8 = ia.quant_i8(mm(p, v), out_scale.float(), out_zp.float(), a_bit)
        return (o8, lg) if logits else o8

    return core


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest with ties away from zero at 13 dropped bits, either
    sign; the split x = hi + lo holds x to about 2^-22 of its size."""
    one = 1.0 + 2.0 ** -11  # a tie between 1 and 1 + 2^-10: away from zero
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, -7.25])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -10, -7.25])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = _tf32(r)
    lo = _tf32(r - hi)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()
    assert ((hi - r).abs() <= r.abs() * 2.0 ** -11).all()


SHAPES = [(L, C) for L in (16, 64, 256) for C in (128, 256, 512)]
B = 2


def _block_inputs(L, C):
    """Seeded numpy inputs of one attention block: a bf16 residual, GroupNorm
    affine, the q / k / v and proj_out quantizations and int8 weights."""
    rng = np.random.default_rng(L * 1000 + C)
    x = (rng.standard_normal((B, L, C)) * 2 + 0.3).astype(ml_dtypes.bfloat16)
    gn = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)

    def quant(a_bit, r):
        return np.full(C, (2 ** a_bit - 1) / (2 * r), np.float32), np.zeros(C, np.float32), a_bit

    def weights():
        return (rng.integers(-8, 8, (C, C)).astype(np.int8),
                np.abs(5e-5 * rng.standard_normal(C) + 2e-4).astype(np.float32),
                (0.1 * rng.standard_normal(C)).astype(np.float32))

    return x, gn, [quant(8, 4), quant(6, 4), quant(8, 4)], [weights() for _ in range(3)], quant(8, 3), weights()


def _conv(tree, f):
    return [tuple(f(a) if isinstance(a, np.ndarray) else a for a in item) for item in tree]


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # exact
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_blocks():
    """JAX's `fused_attention_block` (f32 core, Pallas in interpret mode) at
    every shape of SHAPES, computed once for the module."""
    out = {}
    for L, C in SHAPES:
        x, gn, qkv_quant, qkv_w, o_quant, o_w = _block_inputs(L, C)
        out[L, C] = np.asarray(j_i8.fused_attention_block(
            jnp.asarray(x), *map(jnp.asarray, gn), _conv(qkv_quant, jnp.asarray), _conv(qkv_w, jnp.asarray),
            _conv([o_quant], jnp.asarray)[0], _conv([o_w], jnp.asarray)[0], scale=C ** -0.5,
            interpret=True)).astype(np.float32)
    return out


def _port_block(L, C):
    x, gn, qkv_quant, qkv_w, o_quant, o_w = _block_inputs(L, C)
    return ia.fused_attention_block(_t(x), *map(_t, gn), _conv(qkv_quant, _t), _conv(qkv_w, _t),
                                    _conv([o_quant], _t)[0], _conv([o_w], _t)[0], scale=C ** -0.5)


@pytest.mark.parametrize("L,C", SHAPES)
def test_3xtf32_block_meets_k3_tolerance(jax_blocks, monkeypatch, L, C):
    """The whole block with its core's products in 3xTF32 against the f32
    plain version and against JAX, each at K3's tolerance (mean relative
    error < 1e-3, >= 99% within 1 bf16 ulp)."""
    plain = _port_block(L, C)
    monkeypatch.setattr(ia, "attention_core_ref", _core_emulated(_mm_3xtf32))
    emulated = _port_block(L, C)
    fig = checks.compare("K3", emulated, plain)
    assert fig["ok"], fig
    fig = checks.compare("K3", emulated, torch.from_numpy(jax_blocks[L, C]))
    assert fig["ok"], fig


def _core_inputs(L, C, seed=0):
    rng = np.random.default_rng(seed + L + C)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, C)).astype(np.float32)) for _ in range(3))
    so = torch.full((C,), 255 / 4.0)
    zo = torch.from_numpy(np.round(3 * rng.standard_normal(C)).astype(np.float32))
    return q, k, v, so, zo


@pytest.mark.parametrize("int8_core", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("L,C", SHAPES)
def test_3xtf32_core_codes_meet_k3_core_tolerance(L, C, int8_core):
    """proj_out's input codes of the emulated core against the plain core's:
    at most 1 LSB on at most 0.2% of them (the kernel's `K3.core` check); the
    int8 mode's logits are the plain version's to the bit."""
    q, k, v, so, zo = _core_inputs(L, C)
    want, lg_want = ia.attention_core(q, k, v, so, zo, 8, scale=C ** -0.5, int8_core=int8_core, logits=True)
    got, lg = _core_emulated(_mm_3xtf32)(q, k, v, so, zo, 8, scale=C ** -0.5, int8_core=int8_core, logits=True)
    fig = checks.compare("K3.core", got, want)
    assert fig["ok"], fig
    if int8_core:
        assert torch.equal(lg, lg_want)


def test_one_tf32_pass_is_not_an_f32_core():
    """At CIFAR's core shape one TF32 pass (10-bit operands) moves proj_out's
    input codes far more than the 3-term split: the split is what the f32
    core's tolerance needs."""
    L, C = 256, 256
    q, k, v, so, zo = _core_inputs(L, C, seed=5)
    want = ia.attention_core(q, k, v, so, zo, 8, scale=C ** -0.5)
    three = checks.compare("K3.core", _core_emulated(_mm_3xtf32)(q, k, v, so, zo, 8, scale=C ** -0.5), want)
    one = checks.compare("K3.core", _core_emulated(_mm_1xtf32)(q, k, v, so, zo, 8, scale=C ** -0.5), want)
    assert three["ok"] and not one["ok"], (three, one)
    assert one["frac"] > 10 * max(three["frac"], 1.0 / want.numel())


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------


def _configs():
    celeba = dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))
    return {"cifar10": UNetConfig(), "church": UNetConfig.from_config(load_config("church.yml")),
            "celeba-wide": celeba}


CONFIG_SITES = {path: checks.attention_sites(cfg) for path, cfg in _configs().items()}
K3_SHAPES = sorted({(L, C) for sites in CONFIG_SITES.values() for _s, L, C in sites
                    if ia.fused_attention_block_fits(L, C)}
                   | {(L, C) for L in (1, 16, 63, 64, 65, 512, 513, 1000, 1024) for C in ia.K3_WIDTHS})
INT8_SHAPES = sorted({(L, C) for sites in CONFIG_SITES.values() for _s, L, C in sites
                      if not ia.fused_attention_block_fits(L, C)}
                     | {(L, C) for L in (64, 1024, 2304, 4096) for C in ia.CORE_WIDTHS})


def test_config_sites_are_the_serving_shapes():
    """The attention shapes of the three configurations, as the serving step
    routes them: CIFAR and church whole blocks (K3), celeba-wide both."""
    shapes = {path: sorted({(L, C) for _s, L, C in sites}) for path, sites in CONFIG_SITES.items()}
    assert shapes == {"cifar10": [(16, 256), (256, 256)], "church": [(64, 512), (256, 512)],
                      "celeba-wide": [(16, 512), (256, 256), (1024, 256), (4096, 128)]}
    assert all(ia.k3_takes(L, C) for L, C in K3_SHAPES if L <= ia.K3_MAX_L)
    assert all(ia.int8_core_takes(L, C) for L, C in INT8_SHAPES)


@pytest.mark.parametrize("int8_core", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("L,C", K3_SHAPES)
def test_k3_core_plan(L, C, int8_core):
    """K3's core: the plan fits a block's shared memory, its blocks and row
    groups cover every query once, the q / k chunks are 128 bytes a row and
    divide C, the p.v passes divide C with at most 64 channels a warp, the v
    tiles divide the padded keys."""
    p = ia.core_plan(L, C, int8_core)
    assert p.smem <= ia.SMEM_PER_BLOCK
    assert p.smem >= p.bq * p.lp * 4 + p.stages * (p.bq + 64) * 128  # the logits and the q / k chunks at least
    assert p.lp % 64 == 0 and 0 <= p.lp - L < 64
    assert p.bq == (64 if p.lp <= 512 else 32)
    row_groups, warps_per_group = p.bq // 16, 8 // (p.bq // 16)
    assert row_groups * warps_per_group == 8
    rows = [blk * p.bq + rg * 16 + r for blk in range(-(-L // p.bq)) for rg in range(row_groups) for r in range(16)]
    assert len(rows) == len(set(rows)) and set(range(L)) <= set(rows) and max(rows) < L + p.bq
    assert p.chunk * (1 if int8_core else 4) == 128 and C % p.chunk == 0
    assert C % p.cp == 0 and p.cp % warps_per_group == 0
    per_warp = p.cp // warps_per_group
    assert per_warp % 8 == 0 and per_warp <= 64
    assert p.lp % p.vk == 0 and p.vk % 8 == 0
    assert p.vk * (p.cp + 8) * 4 <= (p.smem - p.bq * (p.lp + 4) * 4) // p.stages  # a v tile fits a stage
    assert 2 <= p.stages <= 4
    two = p.bq * (p.lp + 4) * 4 + 2 * ((p.smem - p.bq * (p.lp + 4) * 4) // p.stages) <= ia.K3_TWO_BLOCKS
    assert p.smem <= ia.K3_TWO_BLOCKS if two else p.stages == 2  # more stages only while two blocks share an SM


@pytest.mark.parametrize("L,C", INT8_SHAPES)
def test_int8_core_plan(L, C):
    """The K8 / K9 / K10 core: the plan fits, its row groups of 64 queries
    have C / 128 warpgroups (128 channels of p.v each) and cover every query
    once, its key tiles divide L and K10's key blocks."""
    p = ia.int8_core_plan(C)
    assert p.smem <= ia.SMEM_PER_BLOCK
    wgs = C // 128
    assert p.threads == p.bq // 64 * wgs * 128 and p.threads <= 1024
    assert 64 // wgs % 8 == 0  # a warpgroup's share of a 64-key tile is whole n-tiles of 8 keys
    assert (p.bq // 64 * 8 * 1024 <= 64 * C) if wgs > 1 else True  # the p exchange fits over the K tile
    assert p.stages == (2 if C == 512 else 3)
    ring = p.stages * 64 * 3 * C  # K [64][C] int8 and V^T [C][64] bf16 a stage
    assert p.smem >= 1024 + p.bq * C + ring
    rows = [blk * p.bq + rg * 64 + r for blk in range(-(-L // p.bq)) for rg in range(p.bq // 64) for r in range(64)]
    assert len(rows) == len(set(rows)) and set(range(L)) <= set(rows)
    assert L % 64 == 0 and ia._flash_block_k(L) % 64 == 0 and L % ia._flash_block_k(L) == 0


def test_plans_at_the_wrappers_limits():
    """The largest plans: K3 at L = 1024 drops to 32 queries a block; the
    int8 core at C = 512 takes 64 queries, 512 threads and 2 stages; both
    within 227 KB, the int8 core's at C = 512 to the byte."""
    p = ia.core_plan(1024, 512)
    assert (p.bq, p.lp, p.cp, p.stages) == (32, 1024, 256, 2) and p.smem <= ia.SMEM_PER_BLOCK
    assert ia.core_plan(512, 512).bq == 64 and ia.core_plan(513, 128).bq == 32
    assert ia.core_plan(16, 512).stages == 4 and ia.core_plan(256, 256).stages == 2
    q = ia.int8_core_plan(512)
    assert (q.bq, q.threads, q.stages, q.smem) == (64, 512, 2, ia.SMEM_PER_BLOCK)
    assert ia.int8_core_plan(128)[:3] == (128, 256, 3) and ia.int8_core_plan(256)[:3] == (128, 512, 3)


# ---------------------------------------------------------------------------
# sites off the kernels' widths
# ---------------------------------------------------------------------------

# mid.attn_1 at 4x4 with C = 384: a whole block K3's CUDA chain is not built for
OFF_K3 = UNetConfig(ch=128, ch_mult=(1, 3), num_res_blocks=1, attn_resolutions=(4,), resolution=8, dropout=0.0)
# down.0.attn.0 at 36x36 (L = 1296, C = 128): composed, and L is no multiple of the int8 core's 64-key tiles
OFF_INT8 = UNetConfig(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(36,), resolution=36, dropout=0.0)


# the 32x32 sites (L = 1024) with C = 512: composed (over K3's budget), so the f32 core is K11, off its head widths
OFF_K11 = UNetConfig(ch=128, ch_mult=(1, 4), num_res_blocks=1, attn_resolutions=(32,), resolution=64, dropout=0.0)
# the same at C = 256: K11's width
ON_K11 = UNetConfig(ch=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(32,), resolution=64, dropout=0.0)


K3_OFF = [(site, 16, 384, "K3") for site in ("down.1.attn.0", "mid.attn_1", "up.1.attn.0", "up.1.attn.1")]
INT8_OFF = [(site, 1296, 128) for site in ("down.0.attn.0", "up.0.attn.0", "up.0.attn.1")]
K11_OFF = [(site, 1024, 512, "K11") for site in ("down.1.attn.0", "mid.attn_1", "up.1.attn.0", "up.1.attn.1")]


@pytest.mark.parametrize("cfg,flags,refused", [
    (OFF_K3, {}, K3_OFF),
    (OFF_K3, dict(attn_int8=False), K3_OFF),
    (OFF_INT8, {}, [(*s, "K8") for s in INT8_OFF]),
    (OFF_INT8, dict(attn_ranges=True), [(*s, "K9") for s in INT8_OFF]),
    (OFF_INT8, dict(attn_int8=False), []),
    (UNetConfig(), {}, []),
    (OFF_K11, dict(attn_int8=False), K11_OFF),
    (OFF_K11, {}, []),
    (ON_K11, dict(attn_int8=False), []),
], ids=["k3", "k3_f32", "k8", "k9", "k11", "cifar10", "k11_c512", "k11_c512_int8", "k11_c256"])
def test_attention_plan_names_refused_sites(cfg, flags, refused):
    """`attention_plan` names each site whose CUDA kernel would refuse its
    map, and `require_attention_kernels` raises with them for a CUDA device
    only (CPU tensors take the plain versions)."""
    assert checks.attention_plan(cfg, **flags)["refused"] == refused
    checks.require_attention_kernels(cfg, "cpu", **flags)
    if refused:
        site, L, C, kind = refused[0]
        with pytest.raises(NotImplementedError, match=rf"{site} \(L={L}, C={C}\) -> {kind}"):
            checks.require_attention_kernels(cfg, "cuda", **flags)
    else:
        checks.require_attention_kernels(cfg, "cuda", **flags)
    assert "refused" not in checks.expected_launches(cfg, **flags)
    if cfg in (OFF_K11, ON_K11) and not flags.get("attn_int8", True):  # the sites are K11's either way
        assert len(checks.attention_plan(cfg, **flags)["K11"]) == 4


def test_sampler_checks_the_sites_before_step_0(monkeypatch):
    """`serving_ddim_sampler`'s sample checks its attention sites against the
    kernels' widths before it runs a step: with the check held to a CUDA
    device, an off-width config stops before the first UNet call."""
    gen = torch.Generator().manual_seed(0)
    params = unet_init(gen, OFF_K3, "cpu")
    q = QuantizedUNet.create(OFF_K3, 4, 8)
    qstates = q.init_state(1, "cpu")
    betas = DiffusionSchedule.create("linear", 1e-4, 0.02, 1000, device="cpu").betas
    sample = srv.serving_ddim_sampler(q, params, qstates, [0], betas, residual_dtype=torch.bfloat16)
    check = checks.require_attention_kernels
    monkeypatch.setattr(srv, "require_attention_kernels", lambda cfg, device, **kw: check(cfg, "cuda", **kw))

    def no_step(*a, **kw):
        raise AssertionError("a step ran before the check")

    monkeypatch.setattr(srv, "serving_unet_apply", no_step)
    with pytest.raises(NotImplementedError, match=r"down\.1\.attn\.0 \(L=16, C=384\) -> K3, mid\.attn_1"):
        sample(torch.randn(1, 8, 8, 3, generator=gen))
