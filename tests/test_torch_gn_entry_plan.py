"""The launch plans of K4's kernel (`ops.fused_gn.epilogue_plan(..., "K4")`,
csrc/gn_epilogue.cuh), which also runs K3's first launch and K12's two
GroupNorm launches, held on the CPU with torch alone.

- At every K4 and K12 shape of the CIFAR-10 (batch 128), LSUN church and
  ImageNet-64 (batch 32) serving steps with the three levers (K4 up to 2048
  channels, and past 32 windows on church's and ImageNet-64's 64^2 to 256^2
  entries), and at toy shapes, for 1 to
  3 outputs and bf16, f32 (and K12's int32) input: the plan and every other
  plan `k4_plans` offers cover every (row, channel) of an image exactly once,
  in whole 32-row windows, whole groups and whole 8-channel vectors, within a
  block's threads and shared memory; images of at most 32 windows take the
  image form where a plan of it fits, larger ones on the 128-channel grid
  the blocked form (not K12's, whose output is halo'd), the rest the
  cluster form.
- A plain-torch emulation of the kernels' split sums (the image form's
  windows and channel slices; the cluster form as `test_torch_gn_plan`
  emulates it; the blocked form's chunks, added by the image's last
  arrival) equals `window_sum` and the group sums to the bit.
- The halo'd consumer: the row -> offset map and the border cells each
  block writes, emulated, give `pad_qzero` of the dense output.
- `epilogue_plan(..., "K4")` raises off the kernel, and `checks.gn_refused`
  names the sites a config would take off the kernels.
"""
import collections

import numpy as np
import pytest
import torch

from attentiondm_tpu_torch.config import load_config
from attentiondm_tpu_torch.models.unet import UNetConfig
from attentiondm_tpu_torch.ops import checks
from attentiondm_tpu_torch.ops import fused_gn as fg
from attentiondm_tpu_torch.ops.pallas_conv import pad_qzero


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """pytest-xdist runs several workers on the machine's cores; one torch
    thread per worker keeps OpenMP from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEVERS = dict(entry_pallas=True, boundary_fusion=True, resblock_pallas="all")
BATCH = {"cifar10": 128, "church": 32, "imagenet64": 32}
# (HW, C) -> K4 launches a serving step with the three levers (`checks.lever_plan`)
K4_SHAPES = {
    "cifar10": {(1024, 128): 2, (256, 128): 1, (64, 256): 1, (16, 256): 1, (16, 512): 3, (64, 512): 3,
                (256, 512): 2, (256, 384): 1, (1024, 384): 1, (1024, 256): 2},
    "church": {(4096, 128): 1, (1024, 256): 1, (256, 256): 1, (64, 512): 1, (64, 1024): 3, (256, 1024): 2,
               (256, 768): 1, (1024, 768): 1, (1024, 512): 2, (4096, 256): 1, (4096, 384): 1, (4096, 512): 2,
               (16384, 128): 2, (16384, 256): 2, (16384, 384): 1, (65536, 128): 3, (65536, 256): 3},
    # the decoder's entries past 1024 channels: (64, 2048), (64, 1536), (256, 1536)
    "imagenet64": {(4096, 128): 3, (1024, 128): 1, (256, 256): 1, (64, 512): 1, (64, 1024): 1, (64, 2048): 3,
                   (64, 1536): 1, (256, 1536): 1, (256, 1024): 2, (256, 768): 1, (1024, 768): 1, (1024, 512): 2,
                   (1024, 384): 1, (4096, 256): 3, (4096, 384): 1},
}
# (H, C) of the K12 blocks
K12_SHAPES = {"cifar10": [(16, 256), (4, 256)], "church": [(16, 512), (8, 512)],
              "imagenet64": [(64, 128), (16, 512), (16, 512)]}
TOY = [(1, 16, 128), (3, 16, 256), (2, 32, 64), (5, 48, 96), (2, 64, 1024), (1, 100, 256), (4, 1024, 128),
       (2, 1600, 256)]
DTYPES = {torch.bfloat16: 2, torch.float32: 4, torch.int32: 4}

K4_CASES = [(B, HW, C) for path, B in BATCH.items() for (HW, C) in K4_SHAPES[path]] + TOY
K12_CASES = [(B, H * H, C) for path, B in BATCH.items() for (H, C) in K12_SHAPES[path]]


def _config(path):
    return UNetConfig() if path == "cifar10" else UNetConfig.from_config(load_config(f"{path}.yml"))


@pytest.mark.parametrize("path", list(BATCH))
def test_shapes_are_the_serving_steps(path):
    plan = checks.lever_plan(_config(path), BATCH[path], **LEVERS)
    assert collections.Counter((HW, C) for _s, HW, C in plan["K4"]) == K4_SHAPES[path]
    assert [(H, C) for _s, H, C in plan["K12"]] == K12_SHAPES[path]


def _blocks(plan, B, HW, N):
    """Per block of one launch (the blocked form: per item): [(image, rows [p0, p1), channels [c0, c1), row
    groups)]."""
    if plan["form"] == "image":
        ns, R = plan["slices"], plan["row_groups"]
        Ns = N // ns
        return [[(blk // ns, 0, HW, blk % ns * Ns, (blk % ns + 1) * Ns, R)] for blk in range(B * ns)]
    if plan["form"] == "blocked":
        R, k = plan["threads"] // (N // fg.VEC), plan["blocks_per_image"]
        return [[(b, j * fg.CHUNK, min((j + 1) * fg.CHUNK, HW), 0, N, R)] for b in range(B) for j in range(k)]
    rows, R = plan["rows"], plan["threads"] // (N // fg.VEC)
    return [[(b, j * rows, min((j + 1) * rows, HW), 0, N, R)] for b in range(B) for j in range(plan["cluster"])]


def _check_plan(plan, B, HW, N, itemsize, n_out):
    V, g, nwin = N // fg.VEC, min(fg.GROUPS, N), -(-HW // fg.WIN)
    cg = N // g
    assert plan["threads"] <= fg.max_threads(n_out) and plan["smem"] <= fg.SMEM_MAX
    if plan["form"] == "image":
        Ns = N // plan["slices"]
        assert nwin <= fg.WIN and N % plan["slices"] == 0 and Ns % fg.VEC == 0 and Ns % cg == 0  # whole groups
        assert plan["threads"] == Ns // fg.VEC * plan["row_groups"] and plan["row_groups"] <= HW
        assert plan["smem"] == fg._image_smem(nwin, Ns)
    elif plan["form"] == "blocked":  # K6's grid: whole chunks, all of an image's in flight at once
        assert N % 128 == 0 and N <= fg.MAX_N and nwin > fg.WIN and plan["rows"] == fg.CHUNK
        assert plan["blocks_per_image"] == -(-HW // fg.CHUNK) <= fg.SMS
        assert plan["threads"] % V == 0 and 1 <= plan["threads"] // V <= fg.WIN
        assert plan["smem"] == fg._blocked_smem(N, plan["threads"])
    else:
        assert 1 <= plan["cluster"] <= max(fg.CLUSTERS) and plan["threads"] % V == 0 and plan["threads"] >= V
        if plan["wpb"] >= fg.WIN:
            assert plan["wpb"] % fg.WIN == 0 and not plan["held"] and plan["threads"] // V <= fg.WIN
        assert plan["smem"] == fg._k2_smem(plan["wpb"], N, itemsize, plan["threads"], plan["held"])
    # every (image, row, channel) once, every block holding whole windows of its image
    seen = torch.zeros((B, HW, V), dtype=torch.int16)  # per 8-channel vector
    for block in _blocks(plan, B, HW, N):
        assert block
        for b, p0, p1, c0, c1, R in block:
            assert p1 > p0 and p0 % fg.WIN == 0 and c0 % cg == 0 and c1 % cg == 0 and c0 % fg.VEC == 0 and R >= 1
            seen[b, p0:p1, c0 // fg.VEC:c1 // fg.VEC] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_out", [1, 2, 3])
@pytest.mark.parametrize("B,HW,N", K4_CASES, ids=str)
def test_k4_plan_covers_every_row_once(B, HW, N, n_out, dtype):
    plan = fg.epilogue_plan(B, HW, N, dtype, "K4", n_out)
    assert plan["kind"] == "K4"
    assert (plan["form"] == "image") == bool(fg.image_plans(B, HW, N, n_out))
    assert plan["form"] == "image" or -(-HW // fg.WIN) > fg.WIN
    assert (plan["form"] == "blocked") == (plan["form"] != "image" and bool(fg.blocked_plans(HW, N, n_out)))
    _check_plan(plan, B, HW, N, DTYPES[dtype], n_out)
    for other in fg.k4_plans(B, HW, N, DTYPES[dtype], n_out):
        _check_plan(other, B, HW, N, DTYPES[dtype], n_out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("B,HW,N", K12_CASES, ids=str)
def test_k12_plans_cover_every_row_once(B, HW, N, dtype):
    """K12's first launch (bf16 residual) and third (conv1's int32 accumulator): halo'd, so never the
    blocked form."""
    plan = fg.epilogue_plan(B, HW, N, dtype, "K4", halo=True)
    assert plan["form"] != "blocked"
    _check_plan(plan, B, HW, N, DTYPES[dtype], 1)
    for other in fg.k4_plans(B, HW, N, DTYPES[dtype], 1, halo=True):
        assert other["form"] != "blocked"
        _check_plan(other, B, HW, N, DTYPES[dtype], 1)


@pytest.mark.parametrize("B,HW,N", [(B, HW, N) for B, HW, N in K4_CASES if -(-HW // fg.WIN) <= fg.WIN], ids=str)
def test_image_form_comes_nearest_a_wave(B, HW, N):
    """The image form takes a row group for each window where a plan has
    that many, and of those the row groups whose threads in all come nearest
    a wave (`WAVE_THREADS`, by ratio), the more threads on a tie."""
    plan = fg.epilogue_plan(B, HW, N, torch.bfloat16, "K4")
    V, nwin = N // fg.VEC, -(-HW // fg.WIN)
    plans = fg.image_plans(B, HW, N)
    if any(p["row_groups"] >= nwin for p in plans):
        assert plan["row_groups"] >= nwin
        plans = [p for p in plans if p["row_groups"] >= nwin]

    def off(p):
        total = B * V * p["row_groups"]
        return max(total / fg.WAVE_THREADS, fg.WAVE_THREADS / total)

    for p in plans:
        assert off(plan) < off(p) or (off(plan) == off(p) and plan["row_groups"] >= p["row_groups"])


@pytest.mark.parametrize("B,HW,N,form", [
    (32, 1024, 128, "image"), (32, 1056, 128, "blocked"), (32, 65536, 256, "blocked"), (4, 132 * 1024, 128, "blocked"),
    (4, 133 * 1024, 128, "cluster"), (32, 4096, 160, "cluster"), (32, 4096, 1024, "blocked"), (2, 1600, 96, "cluster"),
], ids=str)
def test_k4_form_follows_the_shape(B, HW, N, form):
    """`epilogue_plan(..., "K4")`: the image form up to 32 windows, the
    blocked form past them on the 128-channel grid with at most 132 chunks
    an image, the cluster form elsewhere; one output or three, f32 or bf16."""
    for n_out in (1, 3):
        for dtype in (torch.float32, torch.bfloat16):
            plan = fg.epilogue_plan(B, HW, N, dtype, "K4", n_out)
            assert plan["form"] == form, (n_out, dtype, plan)
            if form == "blocked":
                aim = min(512, max(128, fg.WAVE_THREADS // (B * plan["blocks_per_image"])))
                assert plan in fg.blocked_plans(HW, N, n_out)
                assert all(abs(np.log2(plan["threads"] / aim)) <= abs(np.log2(p["threads"] / aim))
                           for p in fg.blocked_plans(HW, N, n_out))


def test_k3_launch_is_bounded_for_three_outputs():
    """Three outputs take at most 256 threads a block (the constants of three quantizations)."""
    for L, C in [(256, 256), (16, 256), (256, 512), (64, 512), (1024, 128)]:
        plan = fg.epilogue_plan(128, L, C, torch.bfloat16, "K4", 3)
        assert plan["threads"] <= 256 == fg.max_threads(3)


@pytest.mark.parametrize("HW,N,dtype,n_out", [
    (16, 2304, torch.bfloat16, 1), (16, 12, torch.bfloat16, 1), (32 * 32 * 1024 + 1, 128, torch.bfloat16, 1),
    (16, 128, torch.float16, 1), (16, 128, torch.bfloat16, 4), (16, 128, torch.bfloat16, 0), (0, 128, torch.float32, 1),
    (1024, 1032, torch.float32, 2)])
def test_epilogue_plan_k4_raises_off_the_kernel(HW, N, dtype, n_out):
    with pytest.raises(NotImplementedError):
        fg.epilogue_plan(2, HW, N, dtype, "K4", n_out)
    assert not fg.gn_act_quant_takes(2, HW, N, dtype, n_out)


def test_plan_args_pack_both_forms():
    image = fg.epilogue_plan(128, 16, 256, torch.bfloat16, "K4")
    cluster = fg.epilogue_plan(32, 4096, 160, torch.bfloat16, "K4")  # off the 128 grid
    blocked = fg.epilogue_plan(32, 4096, 128, torch.bfloat16, "K4")
    assert (image["form"], cluster["form"], blocked["form"]) == ("image", "cluster", "blocked")
    assert list(fg.plan_args(image)) == [1, image["slices"], 0, image["threads"], image["smem"], 0]
    assert list(fg.plan_args(cluster)) == [0, cluster["cluster"], cluster["wpb"], cluster["threads"], cluster["smem"],
                                           int(cluster["held"])]
    assert list(fg.plan_args(blocked)) == [2, 4, 0, blocked["threads"], blocked["smem"], 0]


# ---------------------------------------------------------------------------
# the split sums, emulated
# ---------------------------------------------------------------------------


def _seq(xs):
    acc = torch.zeros_like(xs[0])
    for x in xs:
        acc = acc + x
    return acc


def _window_sums(h):
    """[rows, N] -> [nwin, 2, N]: each 32-row window's sum and sum of squares, rows in order."""
    n = h.shape[0]
    nwin = -(-n // fg.WIN)
    hw = torch.nn.functional.pad(torch.stack([h, h * h], 1), (0, 0, 0, 0, 0, nwin * fg.WIN - n))
    return _seq(list(hw.reshape(nwin, fg.WIN, 2, -1).movedim(1, 0)))


def _image_emulated(h, plan):
    """The image form's group sums [2, G] of one image: per slice, its
    windows (each summed by one row group in row order) added in order, then
    the slice's groups' channels in order."""
    HW, N = h.shape
    g = min(fg.GROUPS, N)
    cg, Ns = N // g, N // plan["slices"]
    out = []
    for sl in range(plan["slices"]):
        red = _seq(list(_window_sums(h[:, sl * Ns:(sl + 1) * Ns])))
        out += [_seq(list(red[:, k * cg:(k + 1) * cg].movedim(1, 0))) for k in range(Ns // cg)]
    return torch.stack(out, 1)


def _cluster_emulated(h, plan):
    """The cluster form's channel sums [2, N] (as test_torch_gn_plan's K2 emulation)."""
    HW = h.shape[0]
    nwin, wpb = -(-HW // fg.WIN), plan["wpb"]
    pub = []
    for j in range(plan["cluster"]):
        ws = _window_sums(h[j * plan["rows"]:min((j + 1) * plan["rows"], HW)])
        pub.append([_seq(list(ws[k:k + fg.WIN])) for k in range(0, ws.shape[0], fg.WIN)] if wpb >= fg.WIN
                   else list(ws))
    S = []
    for g0 in range(0, nwin, fg.WIN * fg.WIN):
        D = []
        for k0 in range(g0, min(g0 + fg.WIN * fg.WIN, nwin), fg.WIN):
            if wpb >= fg.WIN:
                k, cpb = k0 // fg.WIN, wpb // fg.WIN
                D.append(pub[k // cpb][k % cpb])
            else:
                D.append(_seq([pub[w // wpb][w % wpb] for w in range(k0, min(k0 + fg.WIN, nwin))]))
        S.append(_seq(D))
    return _seq(S)


def _blocked_emulated(h, plan):
    """The blocked form's group sums [2, G] of one image: each item's chunk summed per channel (its windows,
    each by one row group in row order, added in order), then, by the image's last arrival, the chunks'
    sums in groups of 32 chunks in order, the groups in order, and the channels of each group in order."""
    HW, N = h.shape
    g = min(fg.GROUPS, N)
    part = [_seq(list(_window_sums(h[k * fg.CHUNK:min((k + 1) * fg.CHUNK, HW)])))
            for k in range(plan["blocks_per_image"])]
    red = _seq([_seq(part[k0:k0 + fg.WIN]) for k0 in range(0, len(part), fg.WIN)])
    return torch.stack([_seq(list(red[:, k * (N // g):(k + 1) * (N // g)].movedim(1, 0))) for k in range(g)], 1)


def _image(HW, N, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(0.3, 2.0, (HW, N)).astype(np.float32)
    h[:, : N // 32] += 40.0  # one group at a large offset, as the kernel checks
    return torch.from_numpy(h)


@pytest.mark.parametrize("B,HW,N", K4_CASES + K12_CASES, ids=str)
def test_split_sums_equal_window_sum(B, HW, N):
    """Under every plan `k4_plans` offers (the chosen one among them), the
    group sums equal `gn_normalize`'s: `window_sum` per channel, then the
    channels of each group in order, to the bit."""
    h = _image(HW, N, HW + N)
    g = min(fg.GROUPS, N)
    want = torch.stack([fg._seq_sum(fg.window_sum(x[None])[0].reshape(g, N // g), -1) for x in (h, h * h)])
    for plan in fg.k4_plans(B, HW, N, 2, 1):
        if plan["form"] == "image":
            got = _image_emulated(h, plan)
        elif plan["form"] == "blocked":
            got = _blocked_emulated(h, plan)
        else:
            red = _cluster_emulated(h, plan)
            got = torch.stack([fg._seq_sum(red[i].reshape(g, N // g), -1) for i in range(2)])
        assert torch.equal(got, want), plan


# ---------------------------------------------------------------------------
# the halo'd consumer
# ---------------------------------------------------------------------------


def _out_row(p, H, W):
    """gne_out_row: the row of an H x W image's row p in its halo'd image."""
    return (p // W + 1) * (W + 2) + p % W + 1


def _border_cell(k, H, W):
    """gne_border: the (y, x) of border cell k."""
    Wp, Hp = W + 2, H + 2
    if k < Wp:
        return 0, k
    if k < 2 * Wp:
        return Hp - 1, k - Wp
    return 1 + (k - 2 * Wp) // 2, (Wp - 1 if (k - 2 * Wp) % 2 else 0)


def _border_threads(plan, N):
    """(k0, dk) of every thread row group that fills an image's border, per block of the image."""
    if plan["form"] == "image":
        R = plan["row_groups"]
        return [(r, R) for r in range(R)]
    R, cl = plan["threads"] // (N // fg.VEC), plan["cluster"]
    return [(rank * R + r, cl * R) for rank in range(cl) for r in range(R)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32])
@pytest.mark.parametrize("B,HW,N", K12_CASES + [(2, 64, 128), (3, 1024, 128), (2, 144, 256)], ids=str)
def test_halo_map_and_border_equal_pad_qzero(B, HW, N, dtype):
    """The kernel writes row p of an image to `_out_row(p)` and its blocks
    fill the border cells `gne_border` enumerates, each once, with the
    per-channel quantized zero: the halo'd buffer equals `pad_qzero` of the
    dense output."""
    H = W = int(HW ** 0.5)
    plan = fg.epilogue_plan(B, HW, N, dtype, "K4", halo=True)
    rng = np.random.default_rng(HW + N)
    dense = torch.from_numpy(rng.integers(-128, 128, (B, HW, N)).astype(np.int8))
    zp = torch.from_numpy(rng.normal(0.0, 60.0, N).astype(np.float32))
    zp[:4] = torch.tensor([200.0, -300.0, 127.5, -128.5])  # clipped, and ties that round to even
    a_bit = 8
    n = 2 ** (a_bit - 1)
    code = torch.clamp(torch.round(-zp), -n, n - 1).to(torch.int8)
    out = torch.zeros((B, (H + 2) * (W + 2), N), dtype=torch.int16)
    writes = torch.zeros((B, (H + 2) * (W + 2)), dtype=torch.int32)
    for block in _blocks(plan, B, HW, N):
        for b, p0, p1, c0, c1, _R in block:
            rows = torch.tensor([_out_row(p, H, W) for p in range(p0, p1)])
            out[b, rows, c0:c1] = dense[b, p0:p1, c0:c1].to(torch.int16)
            if c0 == 0:
                writes[b, rows] += 1
    nb = 2 * (W + 2) + 2 * H
    for b in range(B):
        for k0, dk in _border_threads(plan, N):
            for k in range(k0, nb, dk):
                y, x = _border_cell(k, H, W)
                out[b, y * (W + 2) + x] = code.to(torch.int16)
                writes[b, y * (W + 2) + x] += 1
    assert bool((writes == 1).all())
    want = pad_qzero(dense.reshape(B, H, W, N), zp, a_bit).reshape(B, -1, N)
    assert torch.equal(out.to(torch.int8), want)


# ---------------------------------------------------------------------------
# sites named before step 0
# ---------------------------------------------------------------------------


# a decoder concat of 1536 channels at 4^2: K4 takes it (up to 2048)
WIDE = UNetConfig(ch=128, ch_mult=(1, 6), num_res_blocks=1, attn_resolutions=(), resolution=8, dropout=0.0)
# 1152 channels at the deepest level, concats of 2304: no K2 / K6 epilogue plan, no K4 plan above 2048
WIDER = UNetConfig(ch=128, ch_mult=(1, 9), num_res_blocks=1, attn_resolutions=(), resolution=8, dropout=0.0)


@pytest.mark.parametrize("cfg,levers,kinds", [
    (UNetConfig(), LEVERS, set()), (_config("church"), LEVERS, set()), (_config("church"), {}, set()),
    (WIDE, {}, set()), (WIDE, dict(entry_pallas=True), set()), (WIDER, LEVERS, {"K2/K6", "K7"}),
], ids=["cifar10", "church", "church_off", "wide_off", "wide_entry", "wide_levers"])
def test_gn_refused_names_the_sites(cfg, levers, kinds):
    """No entry is refused: one past K4's widths (WIDER's 2304-channel concats) runs in plain torch, and
    `lever_plan` leaves it out of K4's sites."""
    refused = checks.gn_refused(cfg, 4, **levers)
    assert {kind for *_site, kind in refused} == kinds
    for site, HW, C, kind in refused:
        assert C > 1024
    k4 = checks.lever_plan(cfg, 4, **levers)["K4"]
    assert all(fg.gn_act_quant_takes(4, HW, C) for _s, HW, C in k4)
    if cfg is WIDER:
        assert not any(C > 2048 for _s, _HW, C in k4) and not fg.gn_act_quant_takes(4, 16, 2304)
    checks.require_gn_kernels(cfg, "cpu", 4, **levers)
    if refused:
        site, HW, C, kind = refused[0]
        with pytest.raises(NotImplementedError, match=rf"{site} \(HW={HW}, C={C}\) -> {kind}"):
            checks.require_gn_kernels(cfg, "cuda", 4, **levers)
    else:
        checks.require_gn_kernels(cfg, "cuda", 4, **levers)


def test_gn_refused_covers_every_kernel():
    """An epilogue over the whole-image budget and off K6's grid that K2's
    plan refuses too (K2/K6), an exit past K7's width, a K12 block past
    K12's: each named.  The epilogues are fused blocks' (a multiple of 128
    channels: a block off the 128 grid takes the unfused chain and has no
    epilogue kernel).  At 128 channels a 105 x 105 map, off K6's 8-row grid,
    is K2's (where JAX runs its XLA reference) and refused by none; at 1152
    channels a 35 x 35 map is past K2's 1024 too."""
    off_k6 = UNetConfig(ch=128, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(), resolution=105, dropout=0.0)
    assert checks.gn_refused(off_k6, 2) == []
    past_k2 = UNetConfig(ch=128, ch_mult=(9,), num_res_blocks=1, attn_resolutions=(), resolution=35, dropout=0.0)
    assert {kind for *_s, kind in checks.gn_refused(past_k2, 2)} == {"K2/K6"}
    assert not fg.epilogue_residual_gn_stats_takes(64, 1152) and fg.epilogue_residual_gn_stats_takes(64, 1024)
    from attentiondm_tpu_torch.ops.pallas_resblock import resblock_pallas_takes

    assert resblock_pallas_takes(2, 4, 4, 1024) and not resblock_pallas_takes(2, 4, 4, 1152)
    assert not resblock_pallas_takes(2, 4, 4, 192)


def test_every_plan_is_listed_once():
    """`k4_plans` offers no plan twice, the image form only up to 32 windows, the blocked form only past
    them."""
    for B, HW, N in K4_CASES:
        plans = fg.k4_plans(B, HW, N, 2)
        keys = [tuple(sorted(p.items())) for p in plans]
        assert len(set(keys)) == len(keys)
        assert all(p["form"] in ("cluster", "blocked") for p in plans) or -(-HW // fg.WIN) <= fg.WIN
        assert all(p["form"] != "blocked" for p in plans) or -(-HW // fg.WIN) > fg.WIN
