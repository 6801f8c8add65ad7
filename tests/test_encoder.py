"""Encoder tests: intra byte-parity with the reference encoder, inter
round-trip through the (reference-bit-exact) decoder, and RD quality.
"""

import numpy as np
import pytest

from h264_fer.codec.decoder import Decoder
from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.vio.y4m import Y4MReader, psnr, read_yuv


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def test_intra_byte_parity_with_reference(fixtures_dir, clip):
    """All-intra QP28: our stream must be byte-identical to the reference
    encoder's (same SATD decisions, same CAVLC, same headers)."""
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1))
    mine = enc.encode_sequence(clip[:3])
    ref = (fixtures_dir / "ref_qcif_intra_qp28.264").read_bytes()
    assert mine == ref[: len(mine)]


def test_intra_reconstruction_matches_decode(clip):
    """Encoder in-loop reconstruction == decoder output for intra frames
    (no stale-chroma quirk on I frames with residual)."""
    enc = Encoder(176, 144, EncoderConfig(qp=24, intra_every=1))
    stream = enc.headers() + enc.encode_frame(*clip[0])
    recon = enc.reconstructed()
    dec = list(Decoder().decode_annexb(stream))
    assert len(dec) == 1
    for k in range(3):
        np.testing.assert_array_equal(dec[0][k], recon[k])


def test_ippp_roundtrip_and_quality(fixtures_dir, clip):
    """IPPP QP28: stream decodes in our (reference-bit-exact) decoder;
    PSNR-vs-bitrate must match or beat the reference encoder's."""
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=100))
    mine = enc.encode_sequence(clip)
    dec = list(Decoder().decode_annexb(mine))
    assert len(dec) == len(clip)

    ref_bytes = (fixtures_dir / "ref_qcif_ippp_qp28.264").stat().st_size
    golden = read_yuv(str(fixtures_dir / "ref_qcif_ippp_qp28.golden.yuv"), 176, 144)
    psnr_mine = np.mean([psnr(d[0], s[0]) for d, s in zip(dec, clip)])
    psnr_ref = np.mean([psnr(d[0], s[0]) for d, s in zip(golden, clip)])
    assert len(mine) <= ref_bytes, (len(mine), ref_bytes)
    assert psnr_mine >= psnr_ref - 0.01, (psnr_mine, psnr_ref)


def test_p_skip_and_gop_structure(clip):
    """IntraEvery=4 forces IDR cadence; skip MBs must appear on static
    content (frame repeated => all-skip P frame a few bytes long)."""
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=4))
    static = [clip[0], clip[0], clip[0]]
    data = enc.encode_sequence(static)
    dec = list(Decoder().decode_annexb(data))
    assert len(dec) == 3
    # static P frames are overwhelmingly skip-coded and tiny (a handful of
    # MBs may re-code where quantization error vs source exceeds MAXDIFF)
    sizes = [s["bytes"] for s in enc.stats]
    assert sizes[1] < 100 and sizes[2] < 32, sizes
    assert psnr(dec[1][0], dec[0][0]) > 45.0
    assert psnr(dec[2][0], dec[0][0]) > 45.0


def test_device_iframe_all_device_path(clip):
    """All-device I-frame encode (modes + wavefront recon on device, host
    entropy only): stream decodes identically in our decoder and the
    encoder loop closes (recon == decode)."""
    from h264_fer.codec.device_intra import DeviceIntraPipeline

    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1),
                  device_pipeline=pipe, device_iframe=True)
    stream = enc.headers() + enc.encode_frame(*clip[0])
    rec = enc.reconstructed()
    dec = list(Decoder().decode_annexb(stream))
    assert len(dec) == 1
    for k in range(3):
        np.testing.assert_array_equal(dec[0][k], rec[k])
    # quality close to the exact path
    e0 = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1))
    s0 = e0.headers() + e0.encode_frame(*clip[0])
    d0 = list(Decoder().decode_annexb(s0))
    assert psnr(dec[0][0], clip[0][0]) > psnr(d0[0][0], clip[0][0]) - 0.3
