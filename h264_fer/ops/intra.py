"""Intra prediction: 9 Intra_4x4 modes, 4 Intra_16x16 modes, 4 chroma modes.

Bit-exact re-derivations of the norm 8.3 processes as implemented by the
reference (intra.cpp:140-292 for 4x4, :426-533 for 16x16, :568-687 for
chroma). All functions are batched over leading dims and array-module
generic (NumPy / jax.numpy), matching transform.py's convention.

Neighbor-sample layout (value -1 = unavailable):
  4x4:   p[..., 0] = corner (-1,-1); p[..., 1:5] = left column y=0..3;
         p[..., 5:13] = top row x=0..7 (last 4 = above-right)
  16x16: p[..., 0] = corner; p[..., 1:17] = left; p[..., 17:33] = top
  chroma:p[..., 0] = corner; p[..., 1:9] = left; p[..., 9:17] = top

The device encoder evaluates all modes for all blocks in parallel (the
generalization of the reference's GPU kernels, intra_kernels.cl:308,680);
the decoder indexes a single mode per block.
"""

from __future__ import annotations

import numpy as np


def _xp(x):
    if isinstance(x, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


# ---------------------------------------------------------------------------
# Intra 4x4 luma (norm 8.3.1.2.1-9; reference intra.cpp:140-292).
# Mode numbers: 0 V, 1 H, 2 DC, 3 DDL, 4 DDR, 5 VR, 6 HD, 7 VL, 8 HU.

I4X4_VERTICAL = 0
I4X4_HORIZONTAL = 1
I4X4_DC = 2
I4X4_DIAG_DOWN_LEFT = 3
I4X4_DIAG_DOWN_RIGHT = 4
I4X4_VERTICAL_RIGHT = 5
I4X4_HORIZONTAL_DOWN = 6
I4X4_VERTICAL_LEFT = 7
I4X4_HORIZONTAL_UP = 8


def _p4(p, x, y):
    """p(x, y) macro: x==-1 → left column p[y+1], else top row p[x+5]."""
    return p[..., y + 1] if x == -1 else p[..., x + 5]


def predict_4x4(p, mode: int):
    """Predict one 4x4 block for a static `mode`. p: (..., 13) int32.

    Returns (..., 4, 4). For DC, availability is derived from -1 samples
    exactly as intra.cpp:164-181 (corner null-check ⇒ both edges in-frame).
    """
    xp = _xp(p)

    def P(x, y):
        return _p4(p, x, y)

    rows = []
    if mode == I4X4_VERTICAL:
        row = xp.stack([P(x, -1) for x in range(4)], axis=-1)
        out = xp.broadcast_to(row[..., None, :], row.shape[:-1] + (4, 4))
        return out
    if mode == I4X4_HORIZONTAL:
        col = xp.stack([P(-1, y) for y in range(4)], axis=-1)
        return xp.broadcast_to(col[..., :, None], col.shape[:-1] + (4, 4))
    if mode == I4X4_DC:
        top4 = sum(P(x, -1) for x in range(4))
        left4 = sum(P(-1, y) for y in range(4))
        all_avail = P(-1, -1) != -1
        left_avail = P(-1, 0) != -1
        top_avail = P(0, -1) != -1
        result = xp.where(
            all_avail,
            (top4 + left4 + 4) >> 3,
            xp.where(
                left_avail,
                (left4 + 2) >> 2,
                xp.where(top_avail, (top4 + 2) >> 2, 128),
            ),
        )
        return xp.broadcast_to(result[..., None, None], result.shape + (4, 4))
    if mode == I4X4_DIAG_DOWN_LEFT:
        for y in range(4):
            cells = []
            for x in range(4):
                if x == 3 and y == 3:
                    cells.append((P(6, -1) + 3 * P(7, -1) + 2) >> 2)
                else:
                    cells.append(
                        (P(x + y, -1) + (P(x + y + 1, -1) << 1) + P(x + y + 2, -1) + 2) >> 2
                    )
            rows.append(xp.stack(cells, axis=-1))
        return xp.stack(rows, axis=-2)
    if mode == I4X4_DIAG_DOWN_RIGHT:
        for y in range(4):
            cells = []
            for x in range(4):
                if x > y:
                    v = (P(x - y - 2, -1) + (P(x - y - 1, -1) << 1) + P(x - y, -1) + 2) >> 2
                elif x < y:
                    v = (P(-1, y - x - 2) + (P(-1, y - x - 1) << 1) + P(-1, y - x) + 2) >> 2
                else:
                    v = (P(0, -1) + (P(-1, -1) << 1) + P(-1, 0) + 2) >> 2
                cells.append(v)
            rows.append(xp.stack(cells, axis=-1))
        return xp.stack(rows, axis=-2)
    if mode == I4X4_VERTICAL_RIGHT:
        for y in range(4):
            cells = []
            for x in range(4):
                z = 2 * x - y
                if z in (0, 2, 4, 6):
                    v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1
                elif z in (1, 3, 5):
                    v = (
                        P(x - (y >> 1) - 2, -1)
                        + (P(x - (y >> 1) - 1, -1) << 1)
                        + P(x - (y >> 1), -1)
                        + 2
                    ) >> 2
                elif z == -1:
                    v = (P(-1, 0) + (P(-1, -1) << 1) + P(0, -1) + 2) >> 2
                else:
                    v = (P(-1, y - 1) + (P(-1, y - 2) << 1) + P(-1, y - 3) + 2) >> 2
                cells.append(v)
            rows.append(xp.stack(cells, axis=-1))
        return xp.stack(rows, axis=-2)
    if mode == I4X4_HORIZONTAL_DOWN:
        for y in range(4):
            cells = []
            for x in range(4):
                z = 2 * y - x
                if z in (0, 2, 4, 6):
                    v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1
                elif z in (1, 3, 5):
                    v = (
                        P(-1, y - (x >> 1) - 2)
                        + (P(-1, y - (x >> 1) - 1) << 1)
                        + P(-1, y - (x >> 1))
                        + 2
                    ) >> 2
                elif z == -1:
                    v = (P(-1, 0) + (P(-1, -1) << 1) + P(0, -1) + 2) >> 2
                else:
                    v = (P(x - 1, -1) + (P(x - 2, -1) << 1) + P(x - 3, -1) + 2) >> 2
                cells.append(v)
            rows.append(xp.stack(cells, axis=-1))
        return xp.stack(rows, axis=-2)
    if mode == I4X4_VERTICAL_LEFT:
        for y in range(4):
            cells = []
            for x in range(4):
                if y in (0, 2):
                    v = (P(x + (y >> 1), -1) + P(x + (y >> 1) + 1, -1) + 1) >> 1
                else:
                    v = (
                        P(x + (y >> 1), -1)
                        + (P(x + (y >> 1) + 1, -1) << 1)
                        + P(x + (y >> 1) + 2, -1)
                        + 2
                    ) >> 2
                cells.append(v)
            rows.append(xp.stack(cells, axis=-1))
        return xp.stack(rows, axis=-2)
    if mode == I4X4_HORIZONTAL_UP:
        for y in range(4):
            cells = []
            for x in range(4):
                z = x + 2 * y
                if z in (0, 2, 4):
                    v = (P(-1, y + (x >> 1)) + P(-1, y + (x >> 1) + 1) + 1) >> 1
                elif z in (1, 3):
                    v = (
                        P(-1, y + (x >> 1))
                        + (P(-1, y + (x >> 1) + 1) << 1)
                        + P(-1, y + (x >> 1) + 2)
                        + 2
                    ) >> 2
                elif z == 5:
                    v = (P(-1, 2) + 3 * P(-1, 3) + 2) >> 2
                else:
                    v = P(-1, 3) + xp.zeros_like(p[..., 0])
                cells.append(v)
            rows.append(xp.stack(cells, axis=-1))
        return xp.stack(rows, axis=-2)
    raise ValueError(f"bad intra 4x4 mode {mode}")


def predict_4x4_all_modes(p):
    """Stack of all 9 mode predictions: returns (9, ..., 4, 4)."""
    xp = _xp(p)
    return xp.stack([predict_4x4(p, m) for m in range(9)], axis=0)


# ---------------------------------------------------------------------------
# Intra 16x16 (norm 8.3.3; reference intra.cpp:426-533).
# Mode numbers: 0 V, 1 H, 2 DC, 3 Plane.

I16_VERTICAL = 0
I16_HORIZONTAL = 1
I16_DC = 2
I16_PLANE = 3


def _clip1(xp, v):
    return xp.clip(v, 0, 255)


def predict_16x16(p, mode: int):
    """Predict a 16x16 luma MB. p: (..., 33) int32 → (..., 16, 16)."""
    xp = _xp(p)
    corner = p[..., 0]
    left = p[..., 1:17]
    top = p[..., 17:33]
    shape = p.shape[:-1]
    if mode == I16_VERTICAL:
        return xp.broadcast_to(top[..., None, :], shape + (16, 16))
    if mode == I16_HORIZONTAL:
        return xp.broadcast_to(left[..., :, None], shape + (16, 16))
    if mode == I16_DC:
        sum_top = top.sum(axis=-1)
        sum_left = left.sum(axis=-1)
        result = xp.where(
            corner != -1,
            (sum_top + sum_left + 16) >> 5,
            xp.where(
                left[..., 0] != -1,
                (sum_left + 8) >> 4,
                xp.where(top[..., 0] != -1, (sum_top + 8) >> 4, 128),
            ),
        )
        return xp.broadcast_to(result[..., None, None], shape + (16, 16))
    if mode == I16_PLANE:
        # H = Σ (i+1)·(p[8+i,-1] − p[6−i,-1]), i=0..7 — p[-1,-1] enters at i=7
        idx = np.arange(8)
        w = xp.asarray((idx + 1).astype(np.int32))
        tfull = xp.concatenate([corner[..., None], top], axis=-1)  # x index +1
        lfull = xp.concatenate([corner[..., None], left], axis=-1)
        h = (w * (tfull[..., 9:17] - tfull[..., 7 - idx])).sum(axis=-1)
        v = (w * (lfull[..., 9:17] - lfull[..., 7 - idx])).sum(axis=-1)
        a = (left[..., 15] + top[..., 15]) << 4
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        xs = xp.asarray(np.arange(16, dtype=np.int32) - 7)
        ys = xs
        plane = (
            a[..., None, None]
            + b[..., None, None] * xs[None, :]
            + c[..., None, None] * ys[:, None]
            + 16
        ) >> 5
        return _clip1(xp, plane)
    raise ValueError(f"bad intra 16x16 mode {mode}")


def predict_16x16_all_modes(p):
    xp = _xp(p)
    return xp.stack([predict_16x16(p, m) for m in range(4)], axis=0)


# ---------------------------------------------------------------------------
# Intra chroma (norm 8.3.4; reference intra.cpp:568-687).
# Mode numbers: 0 DC, 1 H, 2 V, 3 Plane.

CHROMA_DC = 0
CHROMA_HORIZONTAL = 1
CHROMA_VERTICAL = 2
CHROMA_PLANE = 3


def predict_chroma(p, mode: int):
    """Predict an 8x8 chroma MB. p: (..., 17) int32 → (..., 8, 8)."""
    xp = _xp(p)
    corner = p[..., 0]
    left = p[..., 1:9]
    top = p[..., 9:17]
    shape = p.shape[:-1]
    if mode == CHROMA_HORIZONTAL:
        return xp.broadcast_to(left[..., :, None], shape + (8, 8))
    if mode == CHROMA_VERTICAL:
        return xp.broadcast_to(top[..., None, :], shape + (8, 8))
    if mode == CHROMA_DC:
        out = xp.zeros(shape + (8, 8), dtype=p.dtype)
        for blk in range(4):
            x0 = (blk & 1) << 2
            y0 = (blk >> 1) << 2
            sum_x = top[..., x0 : x0 + 4].sum(axis=-1)
            sum_y = left[..., y0 : y0 + 4].sum(axis=-1)
            left_avail = left[..., y0] != -1
            top_avail = top[..., x0] != -1
            both = left_avail & top_avail
            if blk in (0, 3):  # corner blocks: prefer both, then left, then top
                r = xp.where(
                    both,
                    (sum_x + sum_y + 4) >> 3,
                    xp.where(
                        left_avail,
                        (sum_y + 2) >> 2,
                        xp.where(top_avail, (sum_x + 2) >> 2, 128),
                    ),
                )
            elif blk == 1:  # top-right: prefer top
                r = xp.where(
                    top_avail,
                    (sum_x + 2) >> 2,
                    xp.where(left_avail, (sum_y + 2) >> 2, 128),
                )
            else:  # blk == 2, bottom-left: prefer left
                r = xp.where(
                    left_avail,
                    (sum_y + 2) >> 2,
                    xp.where(top_avail, (sum_x + 2) >> 2, 128),
                )
            patch = xp.broadcast_to(r[..., None, None], shape + (4, 4))
            if xp is np:
                out[..., y0 : y0 + 4, x0 : x0 + 4] = patch
            else:
                out = out.at[..., y0 : y0 + 4, x0 : x0 + 4].set(patch)
        return out
    if mode == CHROMA_PLANE:
        idx = np.arange(4)
        w = xp.asarray((idx + 1).astype(np.int32))
        tfull = xp.concatenate([corner[..., None], top], axis=-1)
        lfull = xp.concatenate([corner[..., None], left], axis=-1)
        h = (w * (tfull[..., 5:9] - tfull[..., 3 - idx])).sum(axis=-1)
        v = (w * (lfull[..., 5:9] - lfull[..., 3 - idx])).sum(axis=-1)
        a = (left[..., 7] + top[..., 7]) << 4
        b = (34 * h + 32) >> 6
        c = (34 * v + 32) >> 6
        xs = xp.asarray(np.arange(8, dtype=np.int32) - 3)
        plane = (
            a[..., None, None]
            + b[..., None, None] * xs[None, :]
            + c[..., None, None] * xs[:, None]
            + 16
        ) >> 5
        return _clip1(xp, plane)
    raise ValueError(f"bad chroma mode {mode}")


def predict_chroma_all_modes(p):
    xp = _xp(p)
    return xp.stack([predict_chroma(p, m) for m in range(4)], axis=0)


# Encoder's Intra16x16-mode → chroma-mode pairing (intra.cpp:16).
INTRA16_TO_CHROMA_MODE = np.array([2, 1, 0, 3], dtype=np.int32)
