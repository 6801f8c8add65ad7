"""Device-side motion estimation: whole-frame full-search SAD.

Device-idiomatic replacement for the reference's per-MB search loops
(moestimation.cpp:298-390 basic full search, :392-585 feature-indexed
candidates): one jitted pass computes the SAD of *every* 8x8 block of the
frame against *every* integer shift in the ±window, as a scan over shifts
with whole-frame elementwise work per step (no gathers), and
returns the top-K candidates per block by SAD.

The host reranks the K candidates with the |mv − mvp| prediction cost (the
sequential MV-predictor dependency stays on host, mirroring the reference's
top-64 rescoring, moestimation.cpp:277-291) and runs quarter-pel
refinement.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("window", "topk"))
def full_search_topk(src_y, ref_y, window: int = 8, topk: int = 16):
    """Top-K integer MV candidates per 8x8 block.

    src_y, ref_y: (H, W) int32. window: ±search range in pixels.
    Returns (sads, mvx, mvy): each (num_blocks, topk) with mv in full-pel,
    blocks in raster order of the 8x8 grid.

    Edge semantics: the reference window is edge-clamped
    (FillTemp_4x4_refPart, mocomp.cpp:11-36) — equivalently the reference
    plane is edge-padded by `window`.
    """
    H, W = src_y.shape
    hb, wb = H // 8, W // 8
    nb = hb * wb
    refp = jnp.pad(ref_y, window, mode="edge")
    nshift = 2 * window + 1

    def block_sums(diff):
        return (
            diff.reshape(hb, 8, wb, 8).sum(axis=(1, 3)).reshape(nb)
        )

    def one_shift(s):
        dy, dx = s // nshift, s % nshift
        win = jax.lax.dynamic_slice(refp, (dy, dx), (H, W))
        return block_sums(jnp.abs(win - src_y))

    sads_all = jax.lax.map(one_shift, jnp.arange(nshift * nshift))  # (S2, nb)
    neg, idx = jax.lax.top_k(-sads_all.T, topk)  # (nb, topk)
    mvy = (idx // nshift - window) * 4
    mvx = (idx % nshift - window) * 4
    return -neg, mvx, mvy


class DeviceMePipeline:
    """Session wrapper for the device full-search (per frame geometry)."""

    def __init__(self, window: int = 8, topk: int = 16) -> None:
        self.window = window
        self.topk = topk

    def __call__(self, src_y: np.ndarray, ref_y: np.ndarray):
        sads, mvx, mvy = full_search_topk(
            jnp.asarray(src_y, jnp.int32),
            jnp.asarray(ref_y, jnp.int32),
            window=self.window,
            topk=self.topk,
        )
        return np.asarray(sads), np.asarray(mvx), np.asarray(mvy)
