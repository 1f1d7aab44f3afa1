"""GPTQ error-compensated weight rounding for low-bit folds (port of
`attentiondm_tpu/quant/gptq.py`).

The second rounding optimizer beside AdaRound (quant/adaround.py), on the
same path: it emits per-layer rounding offsets relative to floor(ws*g -
wzp), which `ops.quant_conv.fold_weights_int8` adds back in every step's
fold, so the serving kernels are untouched.

Algorithm (Frantar et al. 2022, arXiv:2210.17323): walk the reduction
dimension; after quantizing column j, spread its rounding error over the
columns not yet quantized through the inverse-Hessian Cholesky factor:

    q_j   = round_to_grid(w_j)
    err_j = (w_j - q_j) / U_jj
    W_{:, j+1:} -= err_j * U_{j, j+1:}        (U^T U = H^{-1}, U upper)

with H = E[x_patch x_patch^T] (the Gram of `collect_conv_stats`) and
`act_order` taking the columns by decreasing diag(H).  Compensation can move
a weight several levels, so the offsets are small signed integers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.precision import exact_f32
from .adaround import ConvStats, _folded, _grid, _has_gram, _normalized, _shrink_of, _stacked


@_stacked
@exact_f32()
@torch.no_grad()
def _gptq_opt(g, gram, shrink, *, w_bit: int, symmetric: bool, act_order: bool = True, damp: float = 0.01,
              block: int = 128):
    """Quantize scale-folded weight matrices with error compensation.

    g      [L, K, co] scale-folded weights (kernel / act_scale, flattened HWIO)
    gram   [L, K, K]  normalized input Grams E[x x^T]
    shrink [L, co]    per-channel range shrinks (the fold's grid)
    (or one layer without the L axis).  Returns gq [L, K, co], integer grid
    values in [-n, n-1] (float32).

    The compensation is applied lazily in `block`-column batches (the
    paper's lazy batch updates): inside a block each column's error updates
    the block's later columns, and the block's errors reach the columns after
    it in one [co, block] @ [block, K] product.  Column j's error depends only
    on its value after every earlier column's update, which lands before j is
    quantized either way, so blocked and unblocked orders make the same
    decisions up to f32 summation order."""
    L, K, co = g.shape
    n = 2 ** (w_bit - 1)
    ws, wzp = _grid(g, w_bit, symmetric, shrink)  # [L, 1, co]: the grid the fold recomputes each step
    ws, wzp = ws.transpose(1, 2), wzp.transpose(1, 2)  # [L, co, 1]
    H = gram
    if act_order:
        perm = torch.argsort(-torch.diagonal(H, dim1=1, dim2=2), dim=1, stable=True)  # [L, K]
        inv_perm = torch.argsort(perm, dim=1, stable=True)
        g = torch.take_along_dim(g, perm[:, :, None], dim=1)
        H = torch.take_along_dim(torch.take_along_dim(H, perm[:, :, None], dim=1), perm[:, None, :], dim=2)
    # dead inputs (zero variance) must not be compensated through
    diag = torch.diagonal(H, dim1=1, dim2=2)
    eye = torch.eye(K, dtype=H.dtype, device=H.device)
    H = torch.where(eye.bool(), torch.where(diag > 0, diag, torch.ones_like(diag))[:, None, :], H)
    H = H + (damp * diag.mean(dim=1))[:, None, None] * eye
    Hinv = torch.cholesky_solve(eye.expand(L, K, K), torch.linalg.cholesky(H))
    U = torch.linalg.cholesky(Hinv).transpose(1, 2)  # upper: U^T U = H^{-1}

    block = min(block, K)
    Kp = -(-K // block) * block
    if Kp != K:
        # padded columns: w = 0 and U extended by the identity, so they quantize
        # to inert zero-error rows, sliced off at the end
        U = F.pad(U, (0, Kp - K, 0, Kp - K))
        U[:, torch.arange(K, Kp), torch.arange(K, Kp)] = 1.0
        g = F.pad(g, (0, 0, 0, Kp - K))
    W = g.transpose(1, 2).contiguous()  # [L, co, Kp]
    qs = torch.empty((L, Kp, co), dtype=torch.float32, device=g.device)
    for s in range(0, Kp, block):
        Wb = W[:, :, s:s + block]  # a view: the block's columns are updated in place
        Ubb = U[:, s:s + block, s:s + block]
        Err = torch.empty((L, co, block), dtype=torch.float32, device=g.device)
        for j in range(block):
            w_j = Wb[:, :, j:j + 1]  # [L, co, 1]
            q = torch.clamp(torch.round(ws * w_j - wzp), -n, n - 1)
            dq = (q + wzp) / ws
            err = (w_j - dq) / Ubb[:, j:j + 1, j:j + 1]
            Wb[:, :, j + 1:] -= err * Ubb[:, j:j + 1, j + 1:]
            Wb[:, :, j:j + 1] = dq
            Err[:, :, j:j + 1] = err
            qs[:, s + j, :] = q[:, :, 0]
        if s + block < Kp:  # one product carries the block's errors to the columns after it
            W[:, :, s + block:] -= Err @ U[:, s:s + block, s + block:]
    qs = qs[:, :K]
    if act_order:
        qs = torch.take_along_dim(qs, inv_perm[:, :, None], dim=1)
    return qs


def _offsets_of(gq, g, shrink, w_bit: int, symmetric: bool):
    """GPTQ's grid values as fold offsets: gq - floor(ws*g - wzp), so that
    the fold's floor(base_s) + offset reproduces the decision on each step's
    grid ([L, K, co] stacks)."""
    ws, wzp = _grid(g, w_bit, symmetric, shrink)
    return gq - torch.floor(ws * g - wzp)


def gptq_offsets(kernel, act_scale, stats: ConvStats, w_bit: int, *, symmetric: bool = True, shrink=None,
                 act_order: bool = True):
    """Per-layer GPTQ: integer rounding offsets int16 [kh, kw, ci, co], or
    None when the layer has no Gram."""
    if not _has_gram(kernel, stats):
        return None
    g = _folded(kernel, act_scale)[None]
    sh = _shrink_of(kernel, act_scale, w_bit, symmetric, shrink)[None]
    gq = _gptq_opt(g, _normalized(stats)[None], sh, w_bit=w_bit, symmetric=symmetric, act_order=act_order)
    return _offsets_of(gq, g, sh, w_bit, symmetric)[0].reshape(kernel.shape).to(torch.int16)
