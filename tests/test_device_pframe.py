"""Fully-device P-frame path vs the host per-MB loop: byte identity.

The whole IPPP stream from an Encoder with device_pframe=True must be
byte-identical to the host encoder's, and decode bit-exactly."""

import numpy as np
import pytest

from h264_fer.codec.decoder import Decoder
from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.vio.y4m import Y4MReader


@pytest.mark.parametrize("qp", [28, 40])
def test_device_pframe_stream_byte_identical(fixtures_dir, qp):
    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:5]
    cfg = EncoderConfig(qp=qp, intra_every=100)
    host = Encoder(176, 144, cfg).encode_sequence(frames)
    dev = Encoder(176, 144, cfg, device_pframe=True).encode_sequence(frames)
    assert dev == host

    # decode gate: recon round-trips through our decoder
    dec = list(Decoder().decode_annexb(dev))
    assert len(dec) == len(frames)


def test_device_pframe_state_chain_matches_host(fixtures_dir):
    """Per-MB state after each frame must match (it feeds later frames)."""
    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:4]
    cfg = EncoderConfig(qp=34, intra_every=100)
    eh = Encoder(176, 144, cfg)
    ed = Encoder(176, 144, cfg, device_pframe=True)
    for i, f in enumerate(frames):
        bh = eh.encode_frame(*f)
        bd = ed.encode_frame(*f)
        assert bh == bd, f"frame {i}"
        assert np.array_equal(eh.y, ed.y), f"frame {i}"
        assert np.array_equal(eh.mb_type, ed.mb_type), f"frame {i}"
        assert np.array_equal(eh.mv, ed.mv), f"frame {i}"
        assert np.array_equal(eh.tc_luma, ed.tc_luma), f"frame {i}"
        assert np.array_equal(eh.tc_chroma, ed.tc_chroma), f"frame {i}"
        assert np.array_equal(eh.cbp_luma, ed.cbp_luma), f"frame {i}"
        assert np.array_equal(eh.cbp_chroma, ed.cbp_chroma), f"frame {i}"
        assert np.array_equal(eh.nz_luma, ed.nz_luma), f"frame {i}"
