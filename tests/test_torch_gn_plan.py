"""The launch plans of K2 and K6 (`ops.fused_gn.epilogue_plan`,
csrc/gn_epilogue.cuh), held on the CPU with torch alone.

- Each plan covers every row of an image exactly once, in whole 32-row
  windows (whole 1024-row chunks where a block owns 32 windows or more, and
  for K6), within a block's shared memory, at every epilogue shape of the
  CIFAR-10, LSUN church and celeba-wide serving steps and under every plan
  `k2_plans` offers there; it fills a wave of threads wherever the image has
  the windows for it.
- A plain-torch emulation of the kernels' split sums: each block's window
  (or chunk) sums computed on their own, then combined as the cluster's
  blocks (K2) or the chunk partials (K6) combine them.  Both equal the
  plain versions' sums to the bit (`window_sum`, and the blocked order of
  `epilogue_gn_swish_quant_blocked_ref`).
"""
import dataclasses

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


BATCH = {"cifar10": 128, "church": 32, "celeba-wide": 64}
# (HW, N) -> launches a serving step, per configuration (`checks.conv_plan`)
K2_SHAPES = {
    "cifar10": {(16, 256): 7, (64, 256): 5, (256, 256): 5, (1024, 128): 5},
    "church": {(64, 512): 7, (256, 512): 5, (1024, 256): 5, (4096, 256): 5},
    "celeba-wide": {(16, 512): 7, (64, 256): 5, (256, 256): 5, (1024, 256): 5, (4096, 128): 5},
}
K6_SHAPES = {"cifar10": {}, "church": {(16384, 128): 5, (65536, 128): 5}, "celeba-wide": {}}
DTYPES = {torch.bfloat16: 2, torch.int32: 4}
PATH = [(path, B, HW, N, dtype) for path, B in BATCH.items() for (HW, N) in K2_SHAPES[path] for dtype in DTYPES]
PATH6 = [(path, B, HW, N, dtype) for path, B in BATCH.items() for (HW, N) in K6_SHAPES[path] for dtype in DTYPES]


def _config(path):
    if path == "cifar10":
        return UNetConfig()
    if path == "church":
        return UNetConfig.from_config(load_config("church.yml"))
    return dataclasses.replace(UNetConfig.from_config(load_config("celeba.yml")), attn_resolutions=(64, 32, 16))


@pytest.mark.parametrize("path", list(BATCH))
def test_path_shapes_are_the_serving_steps(path):
    """The shape lists here are the ones `conv_plan` derives from the configs,
    and `expected_launches` counts one K2 or K6 launch a resblock epilogue."""
    cfg = _config(path)
    _k1, k2, k6, _k3, _c = checks.conv_plan(cfg)
    counts = lambda shapes: {s: shapes.count(s) for s in set(shapes)}  # noqa: E731
    assert counts(k2) == K2_SHAPES[path] and counts(k6) == K6_SHAPES[path]
    n = checks.expected_launches(cfg, 3, BATCH[path], attn_int8=False)
    assert (n["K2"], n["K6"]) == (3 * len(k2), 3 * len(k6))


def _k2_blocks(plan, HW):
    """[(row0, row1)] of each block of one image."""
    rows = plan["rows"]
    return [(j * rows, min((j + 1) * rows, HW)) for j in range(plan["cluster"])]


def _check_k2_plan(plan, HW, N, itemsize):
    blocks = _k2_blocks(plan, HW)
    assert blocks[0][0] == 0 and blocks[-1][1] == HW
    for (a0, a1), (b0, _b1) in zip(blocks, blocks[1:]):
        assert a1 == b0  # contiguous, no row twice
    assert all(a1 > a0 for a0, a1 in blocks)  # no empty block
    assert all(a0 % fg.WIN == 0 for a0, _ in blocks)  # whole windows
    if plan["wpb"] >= fg.WIN:
        assert plan["wpb"] % fg.WIN == 0 and all(a0 % fg.CHUNK == 0 for a0, _ in blocks)  # whole chunks
        assert not plan["held"]
    V = N // fg.VEC
    assert plan["threads"] % V == 0 and V <= plan["threads"] <= fg.MAX_THREADS
    assert plan["smem"] == fg._k2_smem(plan["wpb"], N, itemsize, plan["threads"], plan["held"])
    assert plan["smem"] <= 232448
    assert plan["cluster"] in fg.CLUSTERS


@pytest.mark.parametrize("path,B,HW,N,dtype", PATH, ids=str)
def test_k2_plan_covers_every_row_once(path, B, HW, N, dtype):
    plan = fg.epilogue_plan(B, HW, N, dtype, "K2")
    _check_k2_plan(plan, HW, N, DTYPES[dtype])
    for other in fg.k2_plans(HW, N, DTYPES[dtype]):
        _check_k2_plan(other, HW, N, DTYPES[dtype])


@pytest.mark.parametrize("path,B,HW,N,dtype", PATH, ids=str)
def test_k2_plan_fills_a_wave(path, B, HW, N, dtype):
    """A wave of threads (`WAVE_THREADS`: 16 warps on 128 SMs) from the
    smallest cluster that gives one, wherever the image has the windows for
    it; else the largest cluster.  The slab is held in shared memory (one HBM
    read) wherever it takes at most HOLD_MAX bytes."""
    plan = fg.epilogue_plan(B, HW, N, dtype, "K2")
    plans = fg.k2_plans(HW, N, DTYPES[dtype])

    def threads(p):
        return B * p["cluster"] * p["threads"]

    if any(threads(p) >= fg.WAVE_THREADS for p in plans):
        assert threads(plan) >= fg.WAVE_THREADS
        assert all(threads(p) < fg.WAVE_THREADS for p in plans if p["cluster"] < plan["cluster"])
    else:
        assert plan["cluster"] == max(p["cluster"] for p in plans)
    slab = plan["wpb"] * fg.WIN * N * DTYPES[dtype]
    assert plan["held"] == (plan["wpb"] < fg.WIN and slab <= fg.HOLD_MAX)


@pytest.mark.parametrize("path,B,HW,N,dtype", PATH6, ids=str)
def test_k6_plan_covers_every_chunk(path, B, HW, N, dtype):
    plan = fg.epilogue_plan(B, HW, N, dtype, "K6")
    nchunk = plan["blocks_per_image"]
    assert plan["rows"] == fg.CHUNK and (nchunk - 1) * fg.CHUNK < HW <= nchunk * fg.CHUNK
    assert nchunk <= fg.SMS  # every chunk of an image in flight at once: one resident block each
    assert B * nchunk >= fg.SMS
    V = N // fg.VEC
    assert plan["threads"] % V == 0 and plan["threads"] <= fg.MAX_THREADS
    assert plan["smem"] == 4 * 2 * N * (plan["threads"] // V + 1) <= 232448


@pytest.mark.parametrize("HW,N,dtype,kind", [
    (1024, 12, torch.bfloat16, "K2"), (1024, 2048, torch.bfloat16, "K2"), (1024, 128, torch.float32, "K2"),
    (32 * 32 * 1024 + 1, 128, torch.bfloat16, "K2"), (200 * 1024, 128, torch.bfloat16, "K6"),
    (65536, 96, torch.bfloat16, "K6")])
def test_epilogue_plan_raises_off_the_kernels(HW, N, dtype, kind):
    with pytest.raises(NotImplementedError):
        fg.epilogue_plan(2, HW, N, dtype, kind)


# ---------------------------------------------------------------------------
# the split sums, emulated
# ---------------------------------------------------------------------------


def _seq(xs):
    """Add a list of [2, N] tensors in order, starting from 0 as a kernel does."""
    acc = torch.zeros_like(xs[0])
    for x in xs:
        acc = acc + x
    return acc


def _window_sums(h):
    """[rows, N] -> [nwin, 2, N]: each 32-row window's sum and sum of squares,
    rows added in order (one thread's loop)."""
    n = h.shape[0]
    nwin = -(-n // fg.WIN)
    hw = torch.nn.functional.pad(torch.stack([h, h * h], 1), (0, 0, 0, 0, 0, nwin * fg.WIN - n))
    hw = hw.reshape(nwin, fg.WIN, 2, -1)
    acc = torch.zeros_like(hw[:, 0])
    for r in range(fg.WIN):
        acc = acc + hw[:, r]
    return acc


def _k2_emulated(h, plan):
    """A K2 cluster's channel sums of one image h [HW, N]: every block's
    published nodes on its own, then each channel's nodes added in order as
    the block that owns the channel adds them."""
    HW = h.shape[0]
    nwin = -(-HW // fg.WIN)
    pub = []  # per block: its nodes
    for a0, a1 in _k2_blocks(plan, HW):
        ws = _window_sums(h[a0:a1])
        if plan["wpb"] >= fg.WIN:  # whole chunks: windows of a chunk in order
            pub.append([_seq(list(ws[k:k + fg.WIN])) for k in range(0, ws.shape[0], fg.WIN)])
        else:
            pub.append(list(ws))
    wpb = plan["wpb"]
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


def _k6_emulated(h, G):
    """K6's group sums of one image: per chunk item the window sums in order,
    the channels of each group in order; then the chunks' partials in order."""
    HW, N = h.shape
    parts = []
    for q0 in range(0, HW, fg.CHUNK):
        csum = _seq(list(_window_sums(h[q0:q0 + fg.CHUNK])))
        parts.append(_seq(list(csum.reshape(2, G, N // G).movedim(2, 0))))
    return _seq(parts)


def _image(HW, N, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(0.3, 2.0, (HW, N)).astype(np.float32)
    h[:, : N // 32] += 40.0  # one group at a large offset, as the kernel checks
    return torch.from_numpy(h)


EMU_HW = [16, 64, 256, 1024, 4096, 16384, 65536]
EMU_N = [128, 256, 512]


@pytest.mark.parametrize("N", EMU_N)
@pytest.mark.parametrize("HW", EMU_HW)
def test_k2_split_sums_equal_window_sum(HW, N):
    """Under the plan at every configuration's batch, and under every other
    plan `k2_plans` offers, the cluster's sums equal `window_sum`'s bits."""
    h = _image(HW, N, HW + N)
    want = torch.stack([fg.window_sum(h[None])[0], fg.window_sum((h * h)[None])[0]])
    plans = {tuple(sorted(fg.epilogue_plan(B, HW, N, torch.bfloat16, "K2").items())) for B in BATCH.values()}
    plans |= {tuple(sorted(p.items())) for p in fg.k2_plans(HW, N, 2)}
    for plan in map(dict, plans):
        assert torch.equal(_k2_emulated(h, plan), want), plan


@pytest.mark.parametrize("N", EMU_N)
@pytest.mark.parametrize("HW", EMU_HW)
def test_k6_split_sums_equal_the_blocked_order(HW, N):
    """K6's items and partials give the group sums of
    `epilogue_gn_swish_quant_blocked_ref`'s order to the bit."""
    h = _image(HW, N, 7 * HW + N)
    g = min(fg.GROUPS, N)
    nchunk = -(-HW // fg.CHUNK)
    hc = torch.nn.functional.pad(h, (0, 0, 0, nchunk * fg.CHUNK - HW)).reshape(1, nchunk, fg.CHUNK, N)
    want = torch.stack([fg._seq_sum(fg._seq_sum(fg.window_sum(x).reshape(1, nchunk, g, N // g), -1), 1)[0]
                        for x in (hc, hc * hc)])
    assert torch.equal(_k6_emulated(h, g), want)
