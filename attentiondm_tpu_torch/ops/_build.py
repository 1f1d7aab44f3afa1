"""Build and load the CUDA kernels under `attentiondm_tpu_torch/csrc/`.

The sources are compiled with nvcc for `sm_90a` into one shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
into `attentiondm_tpu_torch/_build/` (listed in .gitignore), keyed by a hash
of the sources, so a fresh checkout builds itself.  A missing nvcc or a
failed build raises; nothing falls back.

Compile flags: `-fmad=false` keeps nvcc from contracting `a*b - c` into one
FMA, so every quantize and dequantize step rounds its product first, as
torch's plain versions and JAX do; the kernels write `fmaf` where they
want one (the attention core's dot products).  Each source compiles in its
own nvcc process, all started together, and one more links them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
VEC6 = ctypes.c_void_p * 6  # an array of six device pointers, read by the launcher on the host
_VEC6 = ctypes.POINTER(ctypes.c_void_p)
TILE = ctypes.c_int * 4  # a GEMM's M tiling (bm, cols, rows, imgs), read by the launcher on the host
_TILE = ctypes.POINTER(ctypes.c_int)
GNPLAN = ctypes.c_int * 6  # a GroupNorm launch plan (ops/fused_gn.plan_args), read by the launcher on the host

# C entry points: name -> argtypes (every launcher returns cudaGetLastError())
SIGNATURES = {
    # xp, gqt, inv_ws, zcbias, res (modes 3 / 4) or null, out, B, Hp, Wp, Cp, Ho, Wo, Np, ksize, stride, mode,
    # bm, cols, rows, imgs, stream
    "adm_int8_conv": [_P] * 6 + [_I] * 14 + [_P],
    # x, x_is_int32, inv_ws, zcbias, temb, gn_scale, gn_bias, act_scale, act_zp, out,
    # B, HW, N, groups, n_levels, inv_count, eps, the plan (cluster, wpb, threads, smem, held), stream
    "adm_epilogue_gn_swish_quant": [_P, _I] + [_P] * 8 + [_I] * 5 + [_F, _F] + [_I] * 5 + [_P],
    # x ... act_zp as above, scratch `partial` [B, nchunk, 2, groups] f32 and `flags` [B + 1] int32 zeroed,
    # out, B, HW, N, groups, n_levels, inv_count, eps, the plan (threads, smem), stream
    "adm_epilogue_gn_swish_quant_blocked": [_P, _I] + [_P] * 10 + [_I] * 5 + [_F, _F] + [_I] * 2 + [_P],
    # x, x_is_f32, gn (2,C), sqkv (6,C), n_q, n_k, n_v, wq, wk, wv, eqkv (6,C), sqo (4,C), n_o, wo,
    # scratch q8 k8 v8 qf kf vf o8, amax [B, 2] zeroed (the int8 core) or null (the f32 core), out,
    # B, L, C, groups, inv_count, eps, scale, bm, cols (the projections' M tiling), the core's plan (bq, vk,
    # smem), the GroupNorm launch's plan, stream; the weights K-major
    "adm_fused_attention_block": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]
    + [_P] * 9 + [_I] * 4 + [_F, _F, _F] + [_I] * 5 + [_TILE, _P],
    # K3's core alone: q, k, v (f32), scratch q8, k8, amax (int8 core) or nulls, sqo (2, C), n_levels, out,
    # logits or null, B, L, C, plan (bq, vk, smem), scale, stream
    "adm_attention_core": [_P] * 7 + [_I, _P, _P] + [_I] * 6 + [_F, _P],
    # q8, k8, v8, scalars (sq, sk, sv), out_scale, out_zp, n_levels, scratch v^T bf16 [B, C, L], out, B, L, C,
    # block_k, online, scale, plan (bq, stages, smem), stream
    "adm_int8_attention_static": [_P] * 6 + [_I, _P, _P] + [_I] * 5 + [_F] + [_I] * 3 + [_P],
    # dot q k v (int32), (inv_ws, zcbias) x3, out_scale, out_zp, n_levels, scratch amax [B, 2] zeroed, q8, k8,
    # v^T bf16 [B, C, L], out, B, L, C, scale, plan (bq, stages, smem), stream
    "adm_fused_int8_attention": [_P] * 11 + [_I] + [_P] * 5 + [_I] * 3 + [_F] + [_I] * 3 + [_P],
    # q, k, v, out (f32), B, L, D (a head's), heads, block_k, scale, stream
    "adm_flash_attention": [_P] * 4 + [_I] * 5 + [_F, _P],
    # x, x_is_f32, gn_scale, gn_bias, (scale, zp) x3, n_out, n_levels x3, out x3, swish,
    # B, HW, N, groups, inv_count, eps, scratch partial and flags (the blocked form; else null), plan, stream
    "adm_gn_act_quant": [_P, _I] + [_P] * 8 + [_I] * 4 + [_P] * 3 + [_I] * 5 + [_F, _F, _P, _P, _TILE, _P],
    # dot, dot_is_int32, inv_ws, zcbias, x_res, res_is_f32, out, out_is_f32, sums, B, HW, N, groups, plan,
    # channels a thread, stream
    "adm_epilogue_residual_gn_stats": [_P, _I, _P, _P, _P, _I, _P, _I, _P] + [_I] * 4 + [_TILE, _I, _P],
    # r, r_is_f32, tproj, v1 (six vector pointers: gn scale, gn bias, act scale, act zp, inv_ws, zcbias), n1, g1,
    # v2, n2, g2, scratch pad1 acc pad2, out, B, H, W, C, groups, inv_count, eps, tile (bm, cols, rows, imgs),
    # the two GroupNorm launches' plans, stream; g1, g2 K-major
    "adm_resblock": [_P, _I, _P, _VEC6, _I, _P, _VEC6, _I, _P] + [_P] * 4 + [_I] * 5 + [_F, _F, _TILE, _TILE, _TILE,
                                                                                       _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if nvcc is None and toolkit.exists():
        nvcc = str(toolkit)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build from csrc/ on a machine with the "
                           "CUDA toolkit (on PATH or under $CUDA_HOME)")
    return nvcc


def build() -> tuple[Path, float]:
    """Compile the library unless this source hash is already built: one
    nvcc per source into an object, all in parallel, then one link.
    Returns (path, seconds spent compiling)."""
    so = BUILD_DIR / f"libadm_kernels_{source_hash()}.so"
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    cus, _ = _sources()
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cu, o in zip(cus, objs)]
    logs = [(cu.name, p.communicate()[0], p.returncode) for cu, p in zip(cus, procs)]
    tmp = so.with_name(f"{tag}.tmp.so")
    if all(rc == 0 for _, _, rc in logs):
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(("link", link.stdout + link.stderr, link.returncode))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(f"== {name} (rc {rc})\n{out}" for name, out, rc in logs))
    failed = [(name, out, rc) for name, out, rc in logs if rc != 0]
    if failed:
        name, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{out[-8000:]}")
    os.replace(tmp, so)
    return so, seconds


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def f32c(v, device=None):
    """v as a contiguous float32 tensor (itself when it already is one)."""
    import torch

    if v.dtype == torch.float32 and v.is_contiguous() and (device is None or v.device == device):
        return v
    return v.to(device=device, dtype=torch.float32).contiguous()


def require_cuda(name: str, *tensors):
    """Every tensor a kernel takes: on the same CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
