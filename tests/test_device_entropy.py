"""Device whole-slice I16 entropy vs the native C++ packer."""

import numpy as np
import pytest

import jax.numpy as jnp

from h264_fer import native
from h264_fer.codec.device_entropy import i16_slice_entropy
from h264_fer.ops.cavlc_jax import words_to_bytes


def _random_frame_levels(rng, nmb, density):
    mode16 = rng.integers(0, 4, nmb).astype(np.int32)
    cmode = rng.integers(0, 4, nmb).astype(np.int32)

    def lv(shape, amp):
        x = rng.integers(-amp, amp + 1, shape).astype(np.int32)
        return np.where(rng.random(shape) < density, x, 0)

    i16dc = lv((nmb, 16), 8)
    i16ac = lv((nmb, 16, 15), 30)
    cdc = lv((2, nmb, 4), 6)
    cac = lv((2, nmb, 4, 15), 9)
    # mix in fully-zero MBs (cbp gating paths) and zero-chroma MBs
    zero_mb = rng.random(nmb) < 0.25
    i16ac[zero_mb] = 0
    zc = rng.random(nmb) < 0.3
    cac[:, zc] = 0
    zdc = rng.random(nmb) < 0.3
    cdc[:, zdc] = 0
    return mode16, cmode, i16dc, i16ac, cdc, cac


@pytest.mark.parametrize("wmb,hmb,density", [(9, 11, 0.35), (4, 3, 0.9),
                                             (16, 2, 0.05)])
def test_device_entropy_matches_native(wmb, hmb, density):
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    nmb = wmb * hmb
    rng = np.random.default_rng(nmb)
    mode16, cmode, i16dc, i16ac, cdc, cac = _random_frame_levels(
        rng, nmb, density)

    ref = native.i16_frame_entropy_native(
        mode16, cmode, i16dc, i16ac, cdc, cac, wmb)
    assert ref is not None
    payload_ref, nbits_ref, mb_type_r, cbp_l_r, cbp_c_r, tcl_r, tcc_r = ref

    out = i16_slice_entropy(
        jnp.asarray(mode16), jnp.asarray(cmode), jnp.asarray(i16dc),
        jnp.asarray(i16ac), jnp.asarray(cdc), jnp.asarray(cac),
        wmb=wmb, hmb=hmb)
    nbits = int(out["nbits"])
    assert nbits == nbits_ref
    payload = words_to_bytes(np.asarray(out["words"]), nbits)
    assert payload == payload_ref

    np.testing.assert_array_equal(np.asarray(out["mb_type"]), mb_type_r)
    np.testing.assert_array_equal(np.asarray(out["cbp_luma"]), cbp_l_r)
    np.testing.assert_array_equal(np.asarray(out["cbp_chroma"]), cbp_c_r)
    np.testing.assert_array_equal(np.asarray(out["tc_luma"]), tcl_r)
    np.testing.assert_array_equal(np.asarray(out["tc_chroma"]), tcc_r)
