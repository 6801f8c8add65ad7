"""Tile-sharded IPPP encode (parallel/tile_p.py): every frame — I and P —
split into MB-row bands with reference-window, MV-prediction, nC and
skip-run halos must be byte-identical to the serial device-path IPPP
encoder (SURVEY.md §2.4 tile row)."""

import numpy as np
import pytest

from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.vio.y4m import Y4MReader


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


def _serial(frames, qp, T):
    from h264_fer.codec.device_intra import DeviceIntraPipeline

    pipe = DeviceIntraPipeline(176, 144, qp)
    enc = Encoder(176, 144, EncoderConfig(qp=qp, intra_every=T,
                                          scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=True, device_pframe=True)
    return enc.encode_sequence(frames)


@pytest.mark.parametrize("n_tile", [3])
def test_tile_ippp_equals_serial(clip, n_tile):
    import jax

    from h264_fer.parallel.tile_p import TileIpppEncoder

    frames = clip[:4]
    T = 4
    serial = _serial(frames, 28, T)
    tenc = TileIpppEncoder(176, 144, 28, gop_len=T,
                           devices=jax.devices()[:n_tile])
    assert tenc.encode_sequence(frames) == serial


def test_tile_ippp_multi_gop_and_decode(clip):
    """Two GOPs through the banded pipeline (exercises the IDR reset of
    band MV state) + decoder round trip."""
    import jax

    from h264_fer.codec.decoder import Decoder
    from h264_fer.parallel.tile_p import TileIpppEncoder

    frames = clip[:6]
    T = 3
    serial = _serial(frames, 30, T)
    tenc = TileIpppEncoder(176, 144, 30, gop_len=T,
                           devices=jax.devices()[:3])
    stream = tenc.encode_sequence(frames)
    assert stream == serial
    assert len(list(Decoder().decode_annexb(stream))) == 6


@pytest.mark.parametrize("n_gop,n_tile", [(2, 3), (3, 1)])
def test_gop_tile_2d_ippp_equals_serial(clip, n_gop, n_tile):
    """The full 2-D composition: GOPs data-parallel over ``gop`` x MB-row
    bands over ``tile``, each GOP one device-resident I + scanned-P band
    program — byte-identical to the serial IPPP encoder."""
    import jax

    from h264_fer.parallel.tile_p import GopTileIpppEncoder

    if n_gop * n_tile > len(jax.devices()):
        pytest.skip("needs more virtual devices")
    frames = clip[:7]  # uneven: last GOP padded
    T = 3
    serial = _serial(frames, 28, T)
    genc = GopTileIpppEncoder(176, 144, 28, gop_len=T,
                              n_gop=n_gop, n_tile=n_tile)
    assert genc.encode_sequence(frames) == serial
