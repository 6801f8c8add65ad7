"""Sharded-pipeline tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from h264_fer.codec.device_intra import intra_mode_decision
from h264_fer.parallel.mesh import gop_boundaries, make_mesh, sharded_intra_step


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_intra_matches_single_device():
    """(gop=2, tile=4) sharded mode decision == unsharded, halo included."""
    rng = np.random.default_rng(7)
    B, H, W = 4, 128, 96  # 8x6 MBs per frame, 2-MB-row bands
    batch = rng.integers(0, 256, (B, H, W)).astype(np.int32)

    mesh = make_mesh(2, 4)
    step = sharded_intra_step(mesh, H, W, qp=28)
    m16_sh, m4_sh, satd_sh, q16_sh = step(jnp.asarray(batch))
    # sharded outputs concatenate band results per frame
    m16_sh = np.asarray(m16_sh).reshape(B, -1)
    m4_sh = np.asarray(m4_sh).reshape(B, -1, 16)

    for b in range(B):
        ref = intra_mode_decision(jnp.asarray(batch[b]), wmb=W // 16,
                                  hmb=H // 16, qp=28)
        np.testing.assert_array_equal(m16_sh[b], np.asarray(ref["mode16"]))
        np.testing.assert_array_equal(m4_sh[b], np.asarray(ref["mode4"]))


def test_gop_boundaries():
    assert gop_boundaries(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert gop_boundaries(8, 4) == [(0, 4), (4, 8)]
    assert gop_boundaries(3, 100) == [(0, 3)]
