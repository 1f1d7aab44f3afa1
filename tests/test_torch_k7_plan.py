"""The launch plans of K7 (`ops.fused_gn.epilogue_plan(..., "K7")`,
`k7_plans`; csrc/gn_epilogue.cuh res_gn_stats_kernel), held on the CPU with
torch alone.

- At every K7 shape of the CIFAR-10 (batch 128) and LSUN church (batch 32)
  serving steps with the three levers, on a grid up to the reach of JAX's
  `epilogue_residual_gn_stats_fits` (up to 64 windows at N = 128) and at toy
  shapes past it: the chosen plan and every plan `k7_plans` offers give each
  (image, 32-row window, channel) one owner, in whole groups, within K7's
  launch bound and a block's shared memory, at 8, 4, 2 or 1 channels a thread.
- A plain-torch emulation of the kernel's split sums over r = x_res + (dot *
  inv_ws + zcbias) (per row group its windows in row order, the windows of
  each chunk and then the chunks in order, then each group's channels)
  equals the plain version's sums (`window_sum`'s order) to the bit.
- `epilogue_plan(..., "K7")` raises off the kernel, and `checks.gn_refused`
  names a K7 site no plan takes.
"""
import collections

import numpy as np
import pytest
import torch

from attentiondm_tpu_torch.config import load_config
from attentiondm_tpu_torch.models.unet import UNetConfig
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops import fused_gn as fg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEVERS = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
BATCH = {"cifar10": 128, "church": 32}
# (HW, N) -> K7 launches a serving step with the three levers (`checks.lever_plan`)
K7_SHAPES = {"cifar10": {(1024, 128): 1, (64, 256): 1, (16, 256): 2}, "church": {(1024, 256): 1, (64, 512): 2}}
SERVING = [(B, HW, N) for path, B in BATCH.items() for (HW, N) in K7_SHAPES[path]]
# JAX's reach (HW on the 8 grid, N on the 128 grid, HW * N * 16 <= 4 MiB): 33 to 64 windows at N = 128 only
GRID = [(2, HW, N) for N in range(128, 1025, 128)
        for HW in (8, 16, 24, 40, 64, 256, 512, 1000, 1024, 1032, 1056, 1536, 2040, 2048)
        if fg.epilogue_residual_gn_stats_fits(HW, N)]
# past it: off the 128 grid, odd rows, more windows (the chunk level beyond two chunks)
TOY = [(3, 1, 8), (1, 100, 64), (2, 72, 96), (1, 4100, 128), (1, 8192, 32), (1, 32 * 32 * 32, 8)]
CASES = SERVING + GRID + TOY


def _config(path):
    return UNetConfig() if path == "cifar10" else UNetConfig.from_config(load_config("church.yml"))


@pytest.mark.parametrize("path", list(BATCH))
def test_shapes_are_the_serving_steps(path):
    plan = checks.lever_plan(_config(path), BATCH[path], **LEVERS)
    assert collections.Counter((HW, N) for _s, HW, N in plan["K7"]) == K7_SHAPES[path]


def test_grid_reaches_jax_predicate():
    """The grid holds 33 to 64 windows at N = 128, and JAX's predicate admits nothing past it."""
    nwins = {-(-HW // fg.WIN) for _B, HW, N in GRID if N == 128}
    assert max(nwins) == 64 and any(32 < n < 64 for n in nwins)
    assert not fg.epilogue_residual_gn_stats_fits(2056, 128) and not fg.epilogue_residual_gn_stats_fits(1032, 256)


def _owners(plan, HW, N):
    """Per (window, channel) of an image: how many (slice, thread) pairs of its blocks sum and write it;
    thread t of a slice's block takes channels (t % Vs) * vec + [0, vec) of the slice and windows t // Vs,
    t // Vs + R, ... (every image's blocks alike)."""
    ns, R, vec, T = plan["slices"], plan["row_groups"], plan["vec"], plan["threads"]
    Ns, nwin = N // ns, -(-HW // fg.WIN)
    t = torch.arange(T)
    v, r = t % (Ns // vec), t // (Ns // vec)
    w = torch.arange(nwin)
    owns = ((w[None, :] >= r[:, None]) & ((w[None, :] - r[:, None]) % R == 0)).to(torch.int32)  # [T, nwin]
    seen = torch.zeros((nwin, N), dtype=torch.int32)
    for sl in range(ns):
        ch = (sl * Ns + v[:, None] * vec + torch.arange(vec)[None, :]).reshape(-1)
        seen.index_add_(1, ch, owns.repeat_interleave(vec, dim=0).T.contiguous())
    return seen


def _check_plan(plan, B, HW, N):
    g, nwin = min(fg.GROUPS, N), -(-HW // fg.WIN)
    cg, ns, R = N // g, plan["slices"], plan["row_groups"]
    Ns = N // ns
    assert plan["kind"] == "K7" and plan["form"] == "image" and plan["vec"] in fg.K7_VECS
    assert plan["threads"] <= fg.K7_MAX_THREADS and plan["smem"] <= fg.SMEM_MAX
    assert N % ns == 0 and Ns % fg.VEC == 0 and Ns % cg == 0  # whole 8-channel vectors, whole groups
    assert plan["threads"] == Ns // plan["vec"] * R and R in fg.IMAGE_ROWS and R <= HW
    assert plan["threads"] >= 32 or ns == 1
    assert plan["smem"] == fg._image_smem(nwin, Ns) and nwin <= fg.WIN * fg.WIN
    assert bool((_owners(plan, HW, N) == 1).all())


@pytest.mark.parametrize("B,HW,N", CASES, ids=str)
def test_k7_plans_cover_every_window_once(B, HW, N):
    plans = fg.k7_plans(HW, N)
    assert plans and fg.epilogue_residual_gn_stats_takes(HW, N)
    keys = [tuple(sorted(p.items())) for p in plans]
    assert len(set(keys)) == len(keys)
    for plan in plans:
        _check_plan(plan, B, HW, N)
    for dtype in (torch.bfloat16, torch.int32):
        assert fg.epilogue_plan(B, HW, N, dtype, "K7") in plans


@pytest.mark.parametrize("B,HW,N", CASES, ids=str)
def test_k7_rule_gives_each_window_a_row_group(B, HW, N):
    """The fewest row groups that give every window its own (32 past 32
    windows), of the channels a thread offered there the most whose threads
    in all make half a wave (else the fewest), then the block nearest
    K7_BLOCK threads, the more on a tie."""
    plan = fg.epilogue_plan(B, HW, N, torch.bfloat16, "K7")
    nwin = -(-HW // fg.WIN)
    want_R = min([R for R in fg.IMAGE_ROWS if R >= nwin and R <= HW] or [max(R for R in fg.IMAGE_ROWS if R <= HW)])
    vecs = [v for v in fg.K7_VECS if any((p["row_groups"], p["vec"]) == (want_R, v) for p in fg.k7_plans(HW, N))]
    want_vec = next((v for v in vecs if B * N // v * want_R >= fg.WAVE_THREADS // 2), vecs[-1])
    assert (plan["row_groups"], plan["vec"]) == (want_R, want_vec)

    def off(p):
        return max(p["threads"] / fg.K7_BLOCK, fg.K7_BLOCK / p["threads"])

    for p in fg.k7_plans(HW, N):
        if (p["row_groups"], p["vec"]) == (want_R, want_vec):
            assert off(plan) < off(p) or (off(plan) == off(p) and plan["threads"] >= p["threads"])


def test_serving_plans():
    """The plans of the lever steps' shapes, as the rule picks them."""
    got = {(B, HW, N): (p["vec"], p["slices"], p["row_groups"], p["threads"])
           for B, HW, N in SERVING for p in [fg.epilogue_plan(B, HW, N, torch.bfloat16, "K7")]}
    assert got == {(128, 1024, 128): (8, 4, 32, 128), (128, 64, 256): (2, 2, 2, 128), (128, 16, 256): (1, 2, 1, 128),
                   (32, 1024, 256): (8, 8, 32, 128), (32, 64, 512): (1, 8, 2, 128)}


def test_plan_args_pack_k7():
    plan = fg.epilogue_plan(32, 1024, 256, torch.bfloat16, "K7")
    assert list(fg.plan_args(plan)) == [1, plan["slices"], 0, plan["threads"], plan["smem"], 0]


# ---------------------------------------------------------------------------
# the split sums, emulated
# ---------------------------------------------------------------------------


def _seq(xs):
    acc = torch.zeros_like(xs[0])
    for x in xs:
        acc = acc + x
    return acc


def _emulated(r, plan):
    """The kernel's sums [2, G] of one image's f32 residual' r [HW, N] under
    `plan`: per slice, each window's rows in order (from 0), the windows of
    each chunk of 32 in order, the chunks in order, then each group's
    channels in order."""
    HW, N = r.shape
    g = min(fg.GROUPS, N)
    cg, Ns, nwin = N // g, N // plan["slices"], -(-HW // fg.WIN)
    out = []
    for sl in range(plan["slices"]):
        x = r[:, sl * Ns:(sl + 1) * Ns]
        x = torch.nn.functional.pad(torch.stack([x, x * x], 1), (0, 0, 0, 0, 0, nwin * fg.WIN - HW))
        win = _seq(list(x.reshape(nwin, fg.WIN, 2, Ns).movedim(1, 0)))  # [nwin, 2, Ns]
        red = _seq([_seq(list(win[k:k + fg.WIN])) for k in range(0, nwin, fg.WIN)])
        out += [_seq(list(red[:, k * cg:(k + 1) * cg].movedim(1, 0))) for k in range(Ns // cg)]
    return torch.stack(out, 1)


def _inputs(B, HW, N, int32_dot, seed):
    """conv2's output (bf16 with the identity dequant, or int32 with inv_ws /
    zcbias) and a bf16 residual, one channel group at a large offset."""
    rng = np.random.default_rng(seed)
    if int32_dot:
        dot = torch.from_numpy(rng.integers(-20000, 20000, (B, HW, N)).astype(np.int32))
        inv_ws = torch.from_numpy(np.abs(rng.normal(1e-4, 2e-5, N)).astype(np.float32))
        zcbias = torch.from_numpy(rng.normal(0.0, 1.0, N).astype(np.float32))
    else:
        dot = torch.from_numpy(rng.normal(0.2, 1.5, (B, HW, N)).astype(np.float32)).to(torch.bfloat16)
        inv_ws, zcbias = torch.ones(N), torch.zeros(N)
    x = rng.normal(0.5, 2.0, (B, HW, N)).astype(np.float32)
    x[..., : max(1, N // 32)] += 40.0
    return dot, inv_ws, zcbias, torch.from_numpy(x).to(torch.bfloat16)


SUM_CASES = [(B, HW, N) for B, HW, N in SERVING] + [(2, 1032, 128), (1, 1536, 128), (1, 2048, 128),
                                                     (2, 72, 96), (1, 4100, 128), (1, 64, 1024)]


@pytest.mark.parametrize("int32_dot", [False, True], ids=["bf16_dot", "int32_dot"])
@pytest.mark.parametrize("B,HW,N", SUM_CASES, ids=str)
def test_split_sums_equal_window_sum(B, HW, N, int32_dot):
    """Under every channel slicing `k7_plans` offers (the sums' order
    depends on nothing else: a channel's windows and rows add in one order
    whichever row group and thread own them), the emulated kernel sums of r
    = x_res + (dot * inv_ws + zcbias) equal the plain version's to the bit;
    residual' is the plain version's r rounded to the output dtype."""
    B = min(B, 2)
    dot, inv_ws, zcbias, x_res = _inputs(B, HW, N, int32_dot, HW + N)
    out, sums = fg.epilogue_residual_gn_stats_ref(dot, inv_ws, zcbias, x_res, out_dtype=torch.bfloat16)
    r = x_res.float() + (dot.float() * inv_ws + zcbias)
    assert torch.equal(out, r.to(torch.bfloat16))
    for ns in sorted({p["slices"] for p in fg.k7_plans(HW, N)}):
        for b in range(B):
            assert torch.equal(_emulated(r[b], dict(slices=ns)), sums[b]), ns


# ---------------------------------------------------------------------------
# off the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("HW,N,dtype", [
    (16, 1152, torch.bfloat16), (16, 12, torch.bfloat16), (0, 128, torch.bfloat16),
    (32 * 32 * 32 + 1, 128, torch.int32), (16, 128, torch.float32), (16, 2048, torch.int32)])
def test_epilogue_plan_k7_raises_off_the_kernel(HW, N, dtype):
    with pytest.raises(NotImplementedError):
        fg.epilogue_plan(2, HW, N, dtype, "K7")
    if dtype != torch.float32:
        assert not fg.epilogue_residual_gn_stats_takes(HW, N)


# 1152 channels at 4^2 with boundary fusion: exits JAX's predicate admits (N on the 128 grid, HW * N * 16 <= 4 MiB)
# and no K7 plan takes
WIDE_EXIT = UNetConfig(ch=128, ch_mult=(1, 9), num_res_blocks=2, attn_resolutions=(), resolution=8, dropout=0.0)


def test_gn_refused_names_k7_sites():
    refused = checks.gn_refused(WIDE_EXIT, 2, boundary_fusion=True)
    k7 = [r for r in refused if r[3] == "K7"]
    assert k7 == [("down.1.block.0", 16, 1152, "K7"), ("down.1.block.1", 16, 1152, "K7")]
    assert fg.epilogue_residual_gn_stats_fits(16, 1152)
    with pytest.raises(NotImplementedError, match=r"down\.1\.block\.0 \(HW=16, C=1152\) -> K7"):
        checks.require_gn_kernels(WIDE_EXIT, "cuda", 2, boundary_fusion=True)
    checks.require_gn_kernels(WIDE_EXIT, "cpu", 2, boundary_fusion=True)
    assert not [r for r in checks.gn_refused(WIDE_EXIT, 2) if r[3] == "K7"]
