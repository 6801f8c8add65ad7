"""Multi-chip sharding: GOP × MB-row-tile mesh (SURVEY.md §2.4, §5.8).

The codec's parallel axes (the counterparts of DP/SP for a video codec):

- ``gop``  — frames (or GOPs) are independent between IDRs: shard the frame
  batch across this axis (data parallelism). Host-side ordered bitstream
  concatenation reassembles the stream.
- ``tile`` — MB-row bands within a frame: shard rows across chips. Intra
  prediction needs the last pixel row of the band above — a one-row halo
  exchanged with ``jax.lax.ppermute`` between devices (the ring-attention-style
  neighbour exchange; SURVEY.md §5.7).

This module builds the mesh and the sharded whole-frame intra step. ME/MC
reference-window halos follow the same pattern with a ±(window+pad) halo.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec.device_intra import intra_mode_decision_impl


def make_mesh(n_gop: int, n_tile: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_gop * n_tile, (len(devices), n_gop, n_tile)
    arr = np.asarray(devices[: n_gop * n_tile]).reshape(n_gop, n_tile)
    return Mesh(arr, ("gop", "tile"))


def sharded_intra_step(mesh: Mesh, frame_h: int, frame_w: int, qp: int):
    """Build a pjit-ed whole-batch intra encode step.

    Input:  (B, H, W) int32 luma batch, sharded (gop, tile, None) —
            each device holds a band of MB rows of a subset of frames.
    Output: per-MB modes/SATDs/levels, sharded the same way.

    Inside each shard the band runs the full batched mode decision; the
    one-row top halo rides a ppermute along ``tile``.
    """
    n_tile = mesh.shape["tile"]
    assert frame_h % (16 * n_tile) == 0, "frame rows must split into MB bands"
    band_h = frame_h // n_tile
    wmb = frame_w // 16
    hmb_band = band_h // 16

    def band_step(y_band):
        # y_band: (B_local, band_h, W) — this device's band of each frame
        tile_idx = jax.lax.axis_index("tile")
        last_rows = y_band[:, -1, :]  # (B_local, W)
        # send my last row to the NEXT tile (its top halo)
        halo = jax.lax.ppermute(
            last_rows,
            axis_name="tile",
            perm=[(i, i + 1) for i in range(n_tile - 1)],
        )
        # tile 0 has no predecessor: unavailable (-1)
        halo = jnp.where(tile_idx == 0, -1, halo)

        def per_frame(y2d, top_row):
            out = intra_mode_decision_impl(
                y2d, wmb=wmb, hmb=hmb_band, qp=qp, top_row=top_row
            )
            return out["mode16"], out["mode4"], out["satd16"], out["q16"]

        return jax.vmap(per_frame)(y_band, halo)

    step = jax.shard_map(
        band_step,
        mesh=mesh,
        in_specs=P("gop", "tile", None),
        out_specs=(
            P("gop", "tile"),
            P("gop", "tile", None),
            P("gop", "tile"),
            P("gop", "tile", None, None, None),
        ),
    )
    return jax.jit(step)


def gop_boundaries(n_frames: int, intra_every: int) -> list[tuple[int, int]]:
    """IDR-delimited GOP spans for host-side GOP scattering."""
    out = []
    start = 0
    while start < n_frames:
        end = min(start + intra_every, n_frames)
        out.append((start, end))
        start = end
    return out
