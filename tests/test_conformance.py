"""Slow conformance guard-rails: the full QP sweeps
and the long drugi.264 decode, promoted from tools/conformance.py into CI.

Run with: python -m pytest tests -m slow
The fast suite (-m "not slow") keeps the spot-check subset in test_rd.py.

Fixtures under tests/fixtures/conformance/ are generated from the
unmodified-reference oracle binaries by tools/gen_conformance_fixtures.py
(reference encoder output streams + RD goldens); the drugi test reads the
x264 stream shipped inside the reference checkout and skips if absent.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np
import pytest

from h264_fer.codec.decoder import Decoder
from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.vio.y4m import Y4MReader, psnr

CONF = pathlib.Path(__file__).parent / "fixtures/conformance"
CLIP = pathlib.Path(__file__).parent / "fixtures/clip_qcif_10f.y4m"
DRUGI = pathlib.Path("/root/reference/fer_h264/fer_h264/drugi.264")

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def clip():
    return list(Y4MReader(str(CLIP)))


@pytest.mark.parametrize("qp", [8, 16, 22, 28, 34, 40, 46])
def test_intra_byte_parity_sweep(clip, qp):
    """Host-exact all-intra output must be byte-identical to the
    reference encoder at every QP (north star; the fixture is the
    reference binary's stream for 2 frames)."""
    ref = (CONF / f"ref_intra_qp{qp}.264").read_bytes()
    enc = Encoder(176, 144, EncoderConfig(qp=qp, intra_every=1))
    mine = enc.encode_sequence(clip[:2])
    assert mine == ref, f"QP{qp}: byte mismatch"


FULL_GRID = [16, 22, 28, 34, 40, 43, 46]


@pytest.fixture(scope="module")
def full_grid_points(clip):
    goldens = json.loads((CONF / "rd_goldens.json").read_text())
    pts = {}
    for qp in FULL_GRID:
        enc = Encoder(176, 144, EncoderConfig(qp=qp, intra_every=100))
        mine = enc.encode_sequence(clip)
        dec = list(Decoder().decode_annexb(mine))
        pm = float(np.mean(
            [psnr(d[0], s[0]) for d, s in zip(dec, clip)]))
        pts[qp] = (len(mine), pm, goldens[str(qp)])
    return pts


@pytest.mark.parametrize("qp", FULL_GRID)
def test_inter_rd_full_grid(full_grid_points, qp):
    """Inter RD must DOMINATE the reference at EVERY QP on the full grid
    (BASELINE.md): PSNR >= reference AND bytes <= reference; the QP46
    bits-for-PSNR trade is licensed by the BD-rate curve guard below."""
    nbytes, pm, ref = full_grid_points[qp]
    assert pm >= ref["psnr"], f"QP{qp}: {pm:.3f}dB < ref {ref['psnr']}dB"
    if qp < FULL_GRID[-1]:
        assert nbytes <= ref["bytes"], (
            f"QP{qp}: {nbytes}B > ref {ref['bytes']}B")


def test_inter_bd_rate_full_grid(full_grid_points):
    from test_rd import bd_rate

    ref_pts = [(v[2]["bytes"], v[2]["psnr"])
               for v in full_grid_points.values()]
    my_pts = [(v[0], v[1]) for v in full_grid_points.values()]
    bd = bd_rate(ref_pts, my_pts)
    assert bd <= 0.0, f"BD-rate {bd:+.2f}% vs reference (> 0 = RD loss)"


@pytest.mark.skipif(not DRUGI.exists(), reason="reference checkout absent")
def test_drugi_decode_39_frames(fixtures_dir):
    """All 39 md5-pinned frames of the x264-encoded drugi.264 stream
    decode bit-exactly (the fixture hashes were produced against the
    reference decoder's YUV output)."""
    hashes = (fixtures_dir / "drugi_frames.md5").read_text().split()
    dec = Decoder()
    data = DRUGI.read_bytes()
    n = 0
    for (y, cb, cr), h in zip(dec.decode_annexb(data), hashes):
        got = hashlib.md5(
            y.tobytes() + cb.tobytes() + cr.tobytes()).hexdigest()
        assert got == h, f"frame {n}: decode mismatch"
        n += 1
    assert n == len(hashes), f"decoded {n} frames, expected {len(hashes)}"
