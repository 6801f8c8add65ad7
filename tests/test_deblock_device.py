"""Device deblocking kernel (kernels/deblock_device.py): bit-identical to the
host per-MB-order oracle codec/loopfilter.deblock_frame."""

import numpy as np
import pytest

from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.codec.loopfilter import deblock_frame
from h264_fer.vio.y4m import Y4MReader


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def _device_vs_host(enc):
    import jax.numpy as jnp

    from h264_fer.kernels.deblock_device import deblock_frame_device

    class S:  # host filter mutates a state snapshot in place
        pass

    st = S()
    st.wmb, st.hmb = enc.wmb, enc.hmb
    st.qpy, st.qpc = enc.qpy, enc.qpc
    st.y = enc.y.copy()
    st.cb = enc.cb.copy()
    st.cr = enc.cr.copy()
    st.mb_intra = enc.mb_intra.copy()
    st.nz_luma = enc.nz_luma.copy()
    st.mv = enc.mv.copy()
    deblock_frame(st)

    dy, dcb, dcr = deblock_frame_device(
        jnp.asarray(enc.y), jnp.asarray(enc.cb), jnp.asarray(enc.cr),
        jnp.asarray(enc.mb_intra), jnp.asarray(enc.nz_luma),
        jnp.asarray(enc.mv),
        wmb=enc.wmb, hmb=enc.hmb, qp=enc.qpy, qpc=enc.qpc)
    np.testing.assert_array_equal(np.asarray(dy), st.y)
    np.testing.assert_array_equal(np.asarray(dcb), st.cb)
    np.testing.assert_array_equal(np.asarray(dcr), st.cr)


@pytest.mark.parametrize("qp", [16, 32, 44])
def test_device_deblock_intra_frame(clip, qp):
    """All-intra frame: bS 3/4 paths (strong + normal filters)."""
    enc = Encoder(176, 144, EncoderConfig(qp=qp, intra_every=100))
    enc.encode_frame(*clip[0])
    _device_vs_host(enc)


def test_device_deblock_inter_frame(clip):
    """P frame: bS 0/1/2 paths (coded-block + MV-delta strengths)."""
    enc = Encoder(176, 144, EncoderConfig(qp=30, intra_every=100))
    for f in clip[:3]:
        enc.encode_frame(*f)
    assert not enc.mb_intra.all()
    _device_vs_host(enc)


def test_device_deblock_low_qp_noop(clip):
    """QP below the alpha/beta threshold: filter is a no-op."""
    enc = Encoder(176, 144, EncoderConfig(qp=8, intra_every=100))
    enc.encode_frame(*clip[0])
    _device_vs_host(enc)
