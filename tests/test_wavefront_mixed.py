"""Device mixed-mode I-frame (exact I4x4-vs-I16 arbitration) parity.

The reference arbitrates per MB by exact coded bit size
(intra.cpp:1088-1107); the host encoder replicates that, and the device
kernel (kernels/wavefront_mixed.py + device_entropy.mixed_slice_entropy)
must produce byte-identical streams when driven by the same pre-decided
modes (the device_pipeline-assisted host path).
"""

import numpy as np
import pytest

from h264_fer.codec.decoder import Decoder
from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.codec.device_intra import DeviceIntraPipeline
from h264_fer.vio.y4m import Y4MReader


def _encode(frames, W, H, qp, device_iframe, nframes=2, intra_every=1):
    enc = Encoder(
        W, H, EncoderConfig(qp=qp, intra_every=intra_every),
        device_pipeline=DeviceIntraPipeline(W, H, qp=qp), device_iframe=device_iframe)
    out = b"".join(enc.encode_frame(*f) for f in frames[:nframes])
    return out, enc


@pytest.mark.parametrize("qp", [12, 20, 28, 40])
def test_mixed_device_matches_host_exact(fixtures_dir, qp):
    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))
    W, H = frames[0][0].shape[1], frames[0][0].shape[0]
    sh, eh = _encode(frames, W, H, qp, device_iframe=False)
    sd, ed = _encode(frames, W, H, qp, device_iframe="mixed")
    assert sh == sd
    for a, b in zip(eh.reconstructed(), ed.reconstructed()):
        np.testing.assert_array_equal(a, b)
    if qp == 12:
        # at low QP both mode classes occur on this clip (6 I4x4 MBs of
        # 99 on frame 0) — the arbitration is actually exercised
        assert ed.mb_i4x4.any() and not ed.mb_i4x4.all()


def test_mixed_ippp_continuation(fixtures_dir):
    """P-frames after a device mixed I-frame: lazy state writeback must
    leave the host encoder in exactly the state the host path produces."""
    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))
    W, H = frames[0][0].shape[1], frames[0][0].shape[0]
    sh, _ = _encode(frames, W, H, 28, device_iframe=False, nframes=4,
                    intra_every=100)
    sd, _ = _encode(frames, W, H, 28, device_iframe="mixed", nframes=4,
                    intra_every=100)
    assert sh == sd


def test_mixed_tall_geometry_decodes(fixtures_dir):
    """Tall grid (hmb > wmb) exercises knight-wave slot coverage; the
    stream must round-trip through the decoder bit-exactly."""
    rng = np.random.default_rng(3)
    W, H = 64, 208
    base = rng.integers(0, 200, (H // 16, W // 16))
    y = np.kron(base, np.ones((16, 16))).astype(np.uint8)
    y = np.clip(y + rng.integers(-20, 20, (H, W)), 0, 255).astype(np.uint8)
    cb = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    sh, eh = _encode([(y, cb, cr)], W, H, 30, device_iframe=False, nframes=1)
    sd, ed = _encode([(y, cb, cr)], W, H, 30, device_iframe="mixed", nframes=1)
    assert sh == sd
    enc = Encoder(W, H, EncoderConfig(qp=30),
                  device_pipeline=DeviceIntraPipeline(W, H, qp=30),
                  device_iframe="mixed")
    stream = enc.headers() + enc.encode_frame(y, cb, cr)
    dec = Decoder()
    (dy, dcb, dcr), = list(dec.decode_annexb(stream))
    ry, rcb, rcr = enc.reconstructed()
    np.testing.assert_array_equal(dy, ry)
    np.testing.assert_array_equal(dcb, rcb)
    np.testing.assert_array_equal(dcr, rcr)


@pytest.mark.parametrize("wh", [(176, 144), (80, 176)])  # wide and tall grids
@pytest.mark.parametrize("qp", [10, 28])
def test_mixed_device_matches_host_exact_shapes(wh, qp):
    """The mixed-mode wavefront on wide and tall grids: the device frame
    is byte-identical to the host exact path and leaves the same
    reconstruction."""
    W, H = wh
    rng = np.random.default_rng(W + qp)
    base = rng.integers(0, 200, (H // 16, W // 16))
    y = np.kron(base, np.ones((16, 16)))
    yy, xx = np.mgrid[0:H, 0:W]
    y = np.clip(y + (xx + 2 * yy) % 23 + rng.integers(-12, 12, (H, W)),
                0, 255).astype(np.uint8)
    cb = rng.integers(90, 160, (H // 2, W // 2)).astype(np.uint8)
    cr = rng.integers(90, 160, (H // 2, W // 2)).astype(np.uint8)
    sh, eh = _encode([(y, cb, cr)], W, H, qp, device_iframe=False, nframes=1)
    sd, ed = _encode([(y, cb, cr)], W, H, qp, device_iframe="mixed", nframes=1)
    assert sh == sd
    for a, b in zip(eh.reconstructed(), ed.reconstructed()):
        np.testing.assert_array_equal(a, b)
