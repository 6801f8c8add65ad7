"""Decoder conformance: bit-exact YUV vs the reference decoder.

Golden YUVs were produced by the reference decoder (tools/oracle) on
streams from (a) the reference encoder (intra + IPPP at two QPs) and
(b) x264 (drugi.264 — richer Baseline syntax: SEI, VUI, sub-8x8
partitions, 16x8/8x16, deblocking flags). The north star (BASELINE.json):
byte-for-byte equality.
"""

import hashlib
import pathlib

import numpy as np
import pytest

from h264_fer.codec.decoder import Decoder
from h264_fer.vio.y4m import read_yuv

DRUGI = pathlib.Path("/root/reference/fer_h264/fer_h264/drugi.264")


@pytest.mark.parametrize(
    "name",
    ["ref_qcif_intra_qp28", "ref_qcif_ippp_qp28", "ref_qcif_ippp_qp20"],
)
def test_reference_stream_bit_exact(fixtures_dir, name):
    data = (fixtures_dir / f"{name}.264").read_bytes()
    golden = read_yuv(str(fixtures_dir / f"{name}.golden.yuv"), 176, 144)
    dec = Decoder()
    frames = list(dec.decode_annexb(data))
    assert len(frames) == len(golden)
    for i, (f, g) in enumerate(zip(frames, golden)):
        for k, plane in enumerate("y cb cr".split()):
            np.testing.assert_array_equal(
                f[k], g[k], err_msg=f"{name} frame {i} plane {plane}"
            )


@pytest.mark.skipif(not DRUGI.exists(), reason="reference stream not mounted")
def test_drugi_x264_stream_bit_exact(fixtures_dir):
    """First frames of the x264 stream against reference-decoder hashes.

    Frame 0 additionally compares raw bytes against a stored golden so the
    test is meaningful without the mounted reference too.
    """
    hashes = (fixtures_dir / "drugi_frames.md5").read_text().split()
    golden0 = (fixtures_dir / "drugi_frame0.golden.yuv").read_bytes()
    data = DRUGI.read_bytes()
    dec = Decoder()
    n_check = 6  # keep CI fast; the full 39-frame sweep is in tools/conformance
    for i, f in enumerate(dec.decode_annexb(data)):
        raw = f[0].tobytes() + f[1].tobytes() + f[2].tobytes()
        if i == 0:
            assert raw == golden0
        assert hashlib.md5(raw).hexdigest() == hashes[i], f"frame {i}"
        if i + 1 >= n_check:
            break
