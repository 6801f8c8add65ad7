"""Native whole-slice decoder (native/decoder_native.cpp) produces
byte-identical planes to the Python reference decoder on every stream
family: all-intra (I16+I4x4 mixed), IPPP (P_Skip, partitions, qpel MC),
low-QP dense residual, and deblock-signaled streams (where the filter
runs on native-populated state)."""

import os

import numpy as np
import pytest

from h264_fer.codec.decoder import Decoder
from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.vio.y4m import Y4MReader


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:6]


def _decode_both(stream, deblock=False):
    import h264_fer.native as N

    nat = list(Decoder(deblock=deblock).decode_annexb(stream))
    os.environ["H264_FER_NO_NATIVE"] = "1"
    N._lib = None
    try:
        py = list(Decoder(deblock=deblock).decode_annexb(stream))
    finally:
        del os.environ["H264_FER_NO_NATIVE"]
        N._lib = None
    return nat, py


@pytest.mark.parametrize(
    "qp,intra_every,deblock",
    [(28, 1, False), (28, 100, False), (12, 100, False), (40, 3, False),
     (28, 100, True)],
)
def test_native_decoder_matches_python(clip, qp, intra_every, deblock):
    import h264_fer.native as N

    if N.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    enc = Encoder(176, 144, EncoderConfig(
        qp=qp, intra_every=intra_every, deblock=deblock))
    stream = enc.encode_sequence(clip)
    nat, py = _decode_both(stream, deblock=deblock)
    assert len(nat) == len(py) == len(clip)
    for fi, (a, b) in enumerate(zip(nat, py)):
        for i, name in enumerate(("y", "cb", "cr")):
            assert np.array_equal(a[i], b[i]), f"frame {fi} {name}"
