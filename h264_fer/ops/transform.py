"""Batched integer 4x4 DCT / Hadamard transforms and quantization.

Bit-exact re-derivations of the reference's integer transform pipeline:
  - forward core transform + quant:  quantizationTransform.cpp:41-282
  - inverse scale + transform:       scaleTransform.cpp:101-445
  - chroma QP map:                   inttransform.cpp:8-14

All functions are *batched*: they operate on arrays of shape (..., 4, 4)
(or (..., 2, 2) for chroma DC) with any number of leading batch dimensions,
in int32. They are written array-module-generically so the very same code
runs on NumPy (host decoder, test oracle) and on jax.numpy under jit on device,
with bit-identical results (NumPy and XLA both use arithmetic right shift on
signed ints, matching the reference's g++ semantics).

The device encoder pipeline calls these under jit with leading dims
(num_macroblocks, blocks_per_mb); the 4x4 transforms are exact int32
matrix products.
"""

from __future__ import annotations

import numpy as np

from .tables import (
    INV_ZIGZAG_FLAT,
    LEVEL_QUANTIZE,
    LEVEL_SCALE,
    QPI_TO_QPC,
    ZIGZAG_FLAT,
)


def _xp(x):
    """Array module of `x` (numpy for ndarrays, jax.numpy otherwise)."""
    if isinstance(x, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


# ---------------------------------------------------------------------------
# Forward 4x4 core transform (reference quantizationTransform.cpp:41-100).
#
# The reference computes Y = Cf·X·Cf^T with the scaled butterfly
#   h = (r << 6) - 32            (for nonzero r; 0 stays 0)
#   f = (W·h + 512) >> 10        row pass
#   d = (f·W^T + 512) >> 10      column pass
# where W encodes rows [256,256,256,256], [416,208,-208,-416],
# [256,-256,-256,256], [208,-416,416,-208] (the shift-add constants
# 256=1<<8, 416=(1<<8)+(1<<7)+(1<<5), 208=(1<<7)+(1<<6)+(1<<4)).
_FWD_W = np.array(
    [
        [256, 256, 256, 256],
        [416, 208, -208, -416],
        [256, -256, -256, 256],
        [208, -416, 416, -208],
    ],
    dtype=np.int32,
)

# 4x4 Hadamard matrix used by both DC luma transforms
# (quantizationTransform.cpp:105-152, scaleTransform.cpp:154-192).
_HAD4 = np.array(
    [
        [1, 1, 1, 1],
        [1, 1, -1, -1],
        [1, -1, -1, 1],
        [1, -1, 1, -1],
    ],
    dtype=np.int32,
)

_HAD2 = np.array([[1, 1], [1, -1]], dtype=np.int32)


def forward_transform_4x4(r):
    """Forward scaled 4x4 integer DCT. r: (..., 4, 4) int32 residual.

    Reference: forwardTransform4x4, quantizationTransform.cpp:41-100.
    """
    xp = _xp(r)
    w = xp.asarray(_FWD_W)
    h = xp.where(r == 0, 0, (r << 6) - 32)
    f = (w @ h + 512) >> 10
    d = (f @ w.T + 512) >> 10
    return d


def forward_hadamard_dc_luma(f):
    """Forward 4x4 Hadamard on Intra_16x16 luma DC: (H·f·H^T + 8) >> 4.

    Reference: forwardTransformDCLumaIntra, quantizationTransform.cpp:105-152.
    """
    xp = _xp(f)
    h = xp.asarray(_HAD4)
    return (h @ f @ h.T + 8) >> 4


def forward_hadamard_dc_chroma(f):
    """Forward 2x2 Hadamard on chroma DC: (H2·f·H2 + 2) >> 2.

    Reference: forwardTransformDCChroma, quantizationTransform.cpp:157-178.
    """
    xp = _xp(f)
    h = xp.asarray(_HAD2)
    return (h @ f @ h + 2) >> 2


# ---------------------------------------------------------------------------
# Quantization (encoder side).


def quantize_residual(d, qp: int, dc_bypass: bool):
    """Quantize a transformed 4x4 block at luma/chroma QP `qp`.

    If `dc_bypass` (Intra_16x16 luma or any chroma block), the DC coefficient
    is passed through *unquantized* — it is quantized later in the dedicated
    DC path (the reference's quirk, quantizationTransform.cpp:218-222).

    Reference: quantisationResidualBlock, quantizationTransform.cpp:183-223.
    `qp` must be a Python int (compile-time constant under jit).
    """
    xp = _xp(d)
    lq = xp.asarray(LEVEL_QUANTIZE[qp % 6])
    if qp < 24:
        qbits = 4 - qp // 6
        adjust = 1 << (3 - qp // 6)
        c = (((d << qbits) - adjust) * lq + 16384) >> 15
    else:
        qbits = qp // 6 - 4
        c = ((d >> qbits) * lq + 16384) >> 15
    if dc_bypass:
        c = _set00(xp, c, d[..., 0, 0])
    return c


def quantize_dc_luma(f, qp: int):
    """Quantize Intra_16x16 luma DC Hadamard coefficients.

    Reference: quantisationLumaDCIntra, quantizationTransform.cpp:227-260.
    """
    lq = int(LEVEL_QUANTIZE[qp % 6, 0, 0])
    if qp >= 36:
        qbits = qp // 6 - 6
        return ((f >> qbits) * lq + 16384) >> 15
    adjust = 1 << (5 - qp // 6)
    qbits = 6 - qp // 6
    return (((f << qbits) - adjust) * lq + 16384) >> 15


def quantize_dc_chroma(f, qp: int):
    """Quantize 2x2 chroma DC Hadamard coefficients.

    Reference: quantisationChromaDC, quantizationTransform.cpp:264-282.
    """
    lq = int(LEVEL_QUANTIZE[qp % 6, 0, 0])
    return (((f << 5) >> (qp // 6)) * lq + 16384) >> 15


# ---------------------------------------------------------------------------
# Dequantization ("scaling", decoder side).


def scale_residual(c, qp: int, dc_bypass: bool):
    """Dequantize a 4x4 coefficient block (norm 8.5.12.1).

    If `dc_bypass`, the DC coefficient passes through unscaled (it was scaled
    by the DC path). Reference: scaleResidualBlock, scaleTransform.cpp:308-340.
    """
    xp = _xp(c)
    ls = xp.asarray(LEVEL_SCALE[qp % 6])
    if qp >= 24:
        d = (c * ls) << (qp // 6 - 4)
    else:
        adjust = 1 << (3 - qp // 6)
        d = (c * ls + adjust) >> (4 - qp // 6)
    if dc_bypass:
        d = _set00(xp, d, c[..., 0, 0])
    return d


def scale_dc_luma(f, qp: int):
    """Dequantize Intra_16x16 luma DC after the inverse Hadamard.

    Reference: scaleLumaDCIntra, scaleTransform.cpp:344-404.
    """
    ls = int(LEVEL_SCALE[qp % 6, 0, 0])
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    adjust = 1 << (5 - qp // 6)
    return (f * ls + adjust) >> (6 - qp // 6)


def scale_dc_chroma(f, qp: int):
    """Dequantize 2x2 chroma DC: ((f·LS) << qP//6) >> 5.

    Reference: scaleChromaDC, scaleTransform.cpp:408-445.
    """
    ls = int(LEVEL_SCALE[qp % 6, 0, 0])
    return ((f * ls) << (qp // 6)) >> 5


# ---------------------------------------------------------------------------
# Inverse transforms.


def inverse_transform_4x4(d):
    """Inverse 4x4 core transform, r = round((Ci^T·d·Ci) / 64) (norm 8.5.12.2).

    Butterfly with >>1 on the odd basis rows; final (h + 32) >> 6.
    Reference: inverseTransform4x4, scaleTransform.cpp:101-150.
    """
    d0, d1 = d[..., :, 0], d[..., :, 1]
    d2, d3 = d[..., :, 2], d[..., :, 3]
    xp = _xp(d)
    # row pass (X·A then ·B)
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f0 = e0 + e3
    f1 = e1 + e2
    f2 = e1 - e2
    f3 = e0 - e3
    f = xp.stack([f0, f1, f2, f3], axis=-1)
    # column pass (C·(…) then D·(…))
    f0, f1 = f[..., 0, :], f[..., 1, :]
    f2, f3 = f[..., 2, :], f[..., 3, :]
    g0 = f0 + f2
    g1 = f0 - f2
    g2 = (f1 >> 1) - f3
    g3 = f1 + (f3 >> 1)
    h0 = g0 + g3
    h1 = g1 + g2
    h2 = g1 - g2
    h3 = g0 - g3
    h = xp.stack([h0, h1, h2, h3], axis=-2)
    return (h + 32) >> 6


def inverse_hadamard_dc_luma(c):
    """Inverse 4x4 Hadamard on Intra_16x16 luma DC: H·c·H^T (no rounding).

    Reference: inverseTransformDCLumaIntraFast, scaleTransform.cpp:154-192.
    """
    xp = _xp(c)
    h = xp.asarray(_HAD4)
    return h @ c @ h.T


def inverse_hadamard_dc_chroma(c):
    """Inverse 2x2 Hadamard on chroma DC: H2·c·H2.

    Reference: transformDCChromaFast, scaleTransform.cpp:247-260.
    """
    xp = _xp(c)
    h = xp.asarray(_HAD2)
    return h @ c @ h


# ---------------------------------------------------------------------------
# Composite helpers mirroring the reference's public entry points.


def forward_residual(r, qp: int, dc_bypass: bool):
    """Forward transform + quantize (reference forwardResidual,
    quantizationTransform.cpp:284-291)."""
    return quantize_residual(forward_transform_4x4(r), qp, dc_bypass)


def inverse_residual(c, qp: int, dc_bypass: bool):
    """Dequantize + inverse transform (reference inverseResidual,
    scaleTransform.cpp:465-471)."""
    return inverse_transform_4x4(scale_residual(c, qp, dc_bypass))


def forward_dc_luma(dc, qp: int):
    """Reference forwardDCLumaIntra, quantizationTransform.cpp:293-300."""
    return quantize_dc_luma(forward_hadamard_dc_luma(dc), qp)


def inverse_dc_luma(c, qp: int):
    """Reference InverseDCLumaIntra, scaleTransform.cpp:474-480."""
    return scale_dc_luma(inverse_hadamard_dc_luma(c), qp)


def forward_dc_chroma(dc, qp: int):
    """Reference forwardDCChroma, quantizationTransform.cpp:302-308."""
    return quantize_dc_chroma(forward_hadamard_dc_chroma(dc), qp)


def inverse_dc_chroma(c, qp: int):
    """Reference InverseDCChroma, scaleTransform.cpp:483-490."""
    return scale_dc_chroma(inverse_hadamard_dc_chroma(c), qp)


def chroma_qp(qp_y: int, chroma_qp_index_offset: int = 0) -> int:
    """Map luma QP to chroma QP (norm Table 8-15; inttransform.cpp:22-59)."""
    qpi = min(51, max(0, qp_y + chroma_qp_index_offset))
    return int(QPI_TO_QPC[qpi])


# ---------------------------------------------------------------------------
# Zig-zag scan.


def zigzag_scan(c):
    """Scan (..., 4, 4) coefficient blocks to (..., 16) zig-zag lists.

    Reference: transformScan, quantizationTransform.cpp:310-329.
    """
    xp = _xp(c)
    flat = c.reshape(c.shape[:-2] + (16,))
    return flat[..., xp.asarray(ZIGZAG_FLAT)]


def zigzag_unscan(lst):
    """Inverse scan (..., 16) zig-zag lists to (..., 4, 4) blocks.

    Reference: transformInverseScan, scaleTransform.cpp:454-462.
    """
    xp = _xp(lst)
    out_flat = lst[..., xp.asarray(INV_ZIGZAG_FLAT)]
    return out_flat.reshape(lst.shape[:-1] + (4, 4))


# ---------------------------------------------------------------------------
# Small helpers.


def _set00(xp, a, value):
    """Return a copy of (..., N, N) `a` with [..., 0, 0] replaced by value."""
    if xp is np:
        out = a.copy()
        out[..., 0, 0] = value
        return out
    return a.at[..., 0, 0].set(value)



