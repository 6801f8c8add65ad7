"""Tile-sharded full I-frame encode (parallel/tile.py): MB-row bands with
per-wave reconstructed-row ppermute + cross-band nC context must be
byte-identical to the single-device device_i16_frame path (SURVEY.md §2.4
tile row)."""

import numpy as np
import pytest

from h264_fer.vio.y4m import Y4MReader


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


@pytest.mark.parametrize("n_tile", [3, 9, 2, 4])
def test_tile_sharded_equals_single_device(clip, n_tile):
    # n_tile 2 and 4 do NOT divide QCIF's 9 MB rows: the uneven-band
    # path (padded last band, zero-bit padded MBs) must still stitch a
    # byte-identical stream
    import jax

    from h264_fer.codec.encoder import Encoder, EncoderConfig
    from h264_fer.codec.device_intra import DeviceIntraPipeline
    from h264_fer.parallel.tile import TileIntraEncoder

    if n_tile > len(jax.devices()):
        pytest.skip("needs more virtual devices")
    frames = clip[:2]
    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1,
                                          scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=True)
    serial = enc.encode_sequence(frames)

    tenc = TileIntraEncoder(176, 144, 28, devices=jax.devices()[:n_tile])
    sharded = tenc.encode_sequence(frames)
    assert sharded == serial


@pytest.mark.parametrize("n_gop,n_tile", [(2, 3), (2, 9), (4, 1)])
def test_gop_tile_2d_equals_serial(clip, n_gop, n_tile):
    """The 2-D (gop, tile) program — frames DP-sharded over gop, MB-row
    bands SP-sharded over tile with ppermute halos — stitches streams
    byte-identical to the serial device-path encoder."""
    import jax

    from h264_fer.codec.encoder import Encoder, EncoderConfig
    from h264_fer.codec.device_intra import DeviceIntraPipeline
    from h264_fer.parallel.tile import GopTileIntraEncoder

    if n_gop * n_tile > len(jax.devices()):
        pytest.skip("needs more virtual devices")
    frames = clip[:3]  # uneven over gop=2: exercises padding
    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1,
                                          scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=True)
    serial = enc.encode_sequence(frames)

    genc = GopTileIntraEncoder(176, 144, 28, n_gop=n_gop, n_tile=n_tile)
    assert genc.encode_sequence(frames) == serial


def test_tile_recon_matches_decoder(clip):
    """The band-stitched reconstruction equals what the decoder produces
    from the stitched stream (wavefront halo exchange is exact)."""
    import jax

    from h264_fer.codec.decoder import Decoder
    from h264_fer.parallel.tile import TileIntraEncoder

    tenc = TileIntraEncoder(176, 144, 26, devices=jax.devices()[:3])
    data = tenc.headers() + tenc.encode_frame(*clip[0])
    y, cb, cr = next(iter(Decoder().decode_annexb(data)))
    ry, rcb, rcr = tenc.recon
    np.testing.assert_array_equal(y, ry.astype(np.uint8))
    np.testing.assert_array_equal(cb, rcb.astype(np.uint8))
    np.testing.assert_array_equal(cr, rcr.astype(np.uint8))


@pytest.mark.parametrize("n_tile", [3, 2])
def test_tile_mixed_equals_single_device(clip, n_tile):
    """Banded MIXED-mode I-frames (exact I4x4-vs-I16 arbitration with
    reconstructed-row / choice / TotalCoeff / CBP / mode4 halos) are
    byte-identical to the single-device mixed path — incl. the uneven
    split (hmb=9 over 2 tiles)."""
    import jax

    from h264_fer.codec.decoder import Decoder
    from h264_fer.parallel.gop_device import GopIntraEncoder
    from h264_fer.parallel.tile import TileIntraEncoder

    frames = clip[:2]
    serial = GopIntraEncoder(
        176, 144, 26, mode="mixed",
        devices=jax.devices()[:1]).encode_sequence(frames)
    tiled = TileIntraEncoder(
        176, 144, 26, devices=jax.devices()[:n_tile],
        mode="mixed").encode_sequence(frames)
    assert tiled == serial
    outs = list(Decoder().decode_annexb(tiled))
    assert len(outs) == len(frames)


def test_gop_tile_2d_mixed_equals_serial(clip):
    """The 2-D (gop, tile) mesh with mixed-mode I-frames."""
    import jax

    from h264_fer.parallel.gop_device import GopIntraEncoder
    from h264_fer.parallel.tile import GopTileIntraEncoder

    frames = clip[:3]
    serial = GopIntraEncoder(
        176, 144, 28, mode="mixed",
        devices=jax.devices()[:1]).encode_sequence(frames)
    genc = GopTileIntraEncoder(176, 144, 28, n_gop=2, n_tile=3,
                               mode="mixed")
    assert genc.encode_sequence(frames) == serial
