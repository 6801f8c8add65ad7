"""GOP-axis sharded end-to-end encode: byte parity with the serial
device-path encoder on the virtual 8-device mesh (SURVEY.md §2.4 GOP row,
BASELINE.json config 5)."""

import numpy as np
import pytest

from h264_fer.codec.encoder import Encoder, EncoderConfig
from h264_fer.parallel.gop_device import GopIntraEncoder
from h264_fer.vio.y4m import Y4MReader


@pytest.fixture(scope="module")
def clip(fixtures_dir):
    return list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))


@pytest.mark.parametrize("mode", ["i16", "mixed"])
def test_gop_sharded_equals_serial(clip, mode):
    import jax

    from h264_fer.codec.device_intra import DeviceIntraPipeline

    frames = clip[:4]
    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1,
                                          scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=mode if mode != "i16" else True)
    serial = enc.encode_sequence(frames)

    genc = GopIntraEncoder(176, 144, 28, mode=mode,
                           devices=jax.devices()[:4])
    sharded = genc.encode_sequence(frames)
    assert sharded == serial


def test_gop_sharded_uneven_batch(clip):
    """Frame count not a multiple of the device count still stitches the
    exact ordered stream (padding frames are dropped)."""
    import jax

    from h264_fer.codec.device_intra import DeviceIntraPipeline

    frames = clip[:3]
    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=1,
                                          scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=True)
    serial = enc.encode_sequence(frames)
    genc = GopIntraEncoder(176, 144, 28, devices=jax.devices()[:2])
    assert genc.encode_sequence(frames) == serial


@pytest.mark.parametrize("n_dev,n_frames", [(1, 6), (2, 6), (4, 7)])
def test_gop_ippp_sharded_equals_serial(clip, n_dev, n_frames):
    """Whole-GOP device programs (IDR + scanned P chain) sharded over the
    gop axis must be byte-identical to the serial device-path IPPP
    encoder — including uneven frame/GOP counts and the trailing-skip
    drop state feedback inside the scan."""
    import jax

    from h264_fer.codec.device_intra import DeviceIntraPipeline
    from h264_fer.parallel.gop_device import GopIpppEncoder

    frames = clip[:n_frames]
    T = 3
    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=T,
                                          scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=True, device_pframe=True)
    serial = enc.encode_sequence(frames)

    genc = GopIpppEncoder(176, 144, 28, gop_len=T,
                          devices=jax.devices()[:n_dev])
    assert genc.encode_sequence(frames) == serial


def test_gop_sharded_deblock_streams(clip):
    """Filter-on parallel encode: the sharded
    all-intra stream with in-loop deblocking signaled must be
    byte-identical to the serial device-path encoder with deblock on,
    and its decode must match the encoder's (device-filtered)
    reconstruction."""
    import jax

    from h264_fer.codec.decoder import Decoder
    from h264_fer.codec.device_intra import DeviceIntraPipeline

    frames = clip[:3]
    pipe = DeviceIntraPipeline(176, 144, 30)
    enc = Encoder(176, 144, EncoderConfig(qp=30, intra_every=1,
                                          scene_cut_idr=False, deblock=True),
                  device_pipeline=pipe, device_iframe=True)
    serial = enc.encode_sequence(frames)
    genc = GopIntraEncoder(176, 144, 30, devices=jax.devices()[:2],
                           deblock=True)
    assert genc.encode_sequence(frames) == serial
    outs = list(Decoder(deblock=True).decode_annexb(serial))
    ry, rcb, rcr = enc.reconstructed()
    assert np.array_equal(outs[-1][0], ry)
    assert np.array_equal(outs[-1][1], rcb)
    assert np.array_equal(outs[-1][2], rcr)


def test_gop_ippp_tier_escalation_parity():
    """Content that overflows payload tier 0 on one frame: the serial
    encoder escalates that frame alone, the whole-GOP program re-encodes
    the entire GOP at the higher tier — the streams must still be
    byte-identical (pack_symbols emits the same bits at any adequate
    capacity tier)."""
    import jax

    from h264_fer.codec.device_intra import DeviceIntraPipeline
    from h264_fer.parallel.gop_device import GopIpppEncoder

    W, H, qp = 64, 48, 8
    rng = np.random.default_rng(5)

    def flat(i):
        return (np.full((H, W), 60 + 8 * i, np.uint8),
                np.full((H // 2, W // 2), 120, np.uint8),
                np.full((H // 2, W // 2), 120, np.uint8))

    noisy = (rng.integers(0, 256, (H, W)).astype(np.uint8),
             rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
             rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))
    frames = [flat(0), flat(1), noisy]
    pipe = DeviceIntraPipeline(W, H, qp)
    enc = Encoder(W, H, EncoderConfig(qp=qp, intra_every=3,
                                      scene_cut_idr=False),
                  device_pipeline=pipe, device_iframe=True, device_pframe=True)
    serial = enc.encode_sequence(frames)
    nmb = (W // 16) * (H // 16)
    assert enc.stats[2]["bytes"] * 8 > 32 * nmb * 24, \
        "test content must overflow tier 0 on the noisy frame"
    genc = GopIpppEncoder(W, H, qp, gop_len=3, devices=jax.devices()[:1])
    assert genc.encode_sequence(frames) == serial


def test_gop_ippp_stream_decodes(clip):
    """The GOP-device IPPP stream round-trips through the decoder."""
    from h264_fer.codec.decoder import Decoder
    from h264_fer.parallel.gop_device import GopIpppEncoder

    import jax

    frames = clip[:4]
    genc = GopIpppEncoder(176, 144, 30, gop_len=4,
                          devices=jax.devices()[:1])
    data = genc.encode_sequence(frames)
    outs = list(Decoder().decode_annexb(data))
    assert len(outs) == 4


def test_gop_sharded_stream_decodes(clip):
    """The stitched stream round-trips through the decoder."""
    from h264_fer.codec.decoder import Decoder

    frames = clip[:2]
    genc = GopIntraEncoder(176, 144, 28)
    data = genc.encode_sequence(frames)
    dec = Decoder()
    outs = list(dec.decode_annexb(data))
    assert len(outs) == 2
    for (y, cb, cr), (sy, _, _) in zip(outs, frames):
        assert y.shape == sy.shape


def test_gop_ippp_scene_cut_source_parity(clip):
    """Adaptive IDR placement in the GOP-device orbit: scene_cut_source
    makes the SAD-threshold IDR decision a pure
    function of the input, so variable-length GOPs shard — and the
    stream (incl. the idr_pic_id sequence over back-to-back IDRs) must
    be byte-identical to the serial encoder in the same mode."""
    import jax

    from h264_fer.codec.device_intra import DeviceIntraPipeline
    from h264_fer.parallel.gop_device import GopIpppEncoder

    # hard scene change at frame 3 (inverted content), forced period 4:
    # IDRs at 0 (first), 3 (scene cut), 4 (period) — a length-1 GOP
    frames = list(clip[:3]) + [
        tuple(255 - p for p in f) for f in clip[3:7]]
    T = 4
    pipe = DeviceIntraPipeline(176, 144, 28)
    enc = Encoder(176, 144, EncoderConfig(qp=28, intra_every=T,
                                          scene_cut_idr=True,
                                          scene_cut_source=True),
                  device_pipeline=pipe, device_iframe=True, device_pframe=True)
    serial = enc.encode_sequence(frames)
    idr_frames = [i for i, s in enumerate(enc.stats) if s["idr"]]
    assert 3 in idr_frames and 4 in idr_frames, idr_frames

    genc = GopIpppEncoder(176, 144, 28, gop_len=T,
                          devices=jax.devices()[:2],
                          scene_cut_source=True)
    assert genc.encode_sequence(frames) == serial


@pytest.mark.parametrize("kind,n_dev", [("intra", 1), ("intra", 3),
                                        ("ippp", 1), ("ippp", 3)])
def test_compile_builds_the_program_encode_runs(clip, kind, n_dev):
    """compile() returns the first-tier program encode_sequence runs,
    placed as encode_sequence places it: the encode that follows does not
    compile that program again."""
    import jax
    from jax import monitoring

    from h264_fer.parallel.gop_device import GopIpppEncoder

    frames = clip[:4]
    devs = jax.devices()[:n_dev]
    enc = (GopIntraEncoder(176, 144, 28, devices=devs) if kind == "intra"
           else GopIpppEncoder(176, 144, 28, gop_len=2, devices=devs))
    names = []

    def on_event(event, _secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            names.append(kw.get("fun_name"))

    monitoring.register_event_duration_secs_listener(on_event)
    try:
        compiled = enc.compile(len(frames))
        built, names[:] = set(names), []
        stream = enc.encode_sequence(frames)
        again = set(names)
    finally:
        monitoring.unregister_event_duration_listener(on_event)
    assert built and not built & again
    assert compiled.memory_analysis() is not None
    assert stream.startswith(enc.headers())
