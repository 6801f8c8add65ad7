"""GOP distribution plumbing: multi-host span math + the single-process
path of the cross-host encoder (parallel/dist.py), and norm checks on
GOP-boundary slice headers."""

import numpy as np

from h264_fer.parallel.dist import encode_multihost, gop_spans
from h264_fer.vio.y4m import Y4MReader


def test_gop_spans_balanced_and_idr_aligned():
    spans = gop_spans(n_frames=23, gop_len=4, n_procs=3)
    assert spans[0][0] == 0 and spans[-1][1] == 23
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0  # contiguous
        assert a1 % 4 == 0  # every boundary starts a GOP (an IDR)
    gops = [-(-(b - a) // 4) for a, b in spans]
    assert max(gops) - min(gops) <= 1  # balanced


def test_gop_spans_fewer_gops_than_procs():
    spans = gop_spans(n_frames=3, gop_len=2, n_procs=4)
    assert spans[0] == (0, 2) and spans[1] == (2, 3)
    assert spans[2][0] == spans[2][1]  # idle processes get empty spans


def test_multihost_single_process_matches_gop_encoder(fixtures_dir):
    import jax

    from h264_fer.codec.decoder import Decoder
    from h264_fer.parallel.gop_device import GopIntraEncoder

    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:3]
    out = encode_multihost(frames, 176, 144, qp=28, gop_len=1)
    ref = GopIntraEncoder(176, 144, 28,
                          devices=jax.local_devices()).encode_sequence(frames)
    assert out == ref
    assert len(list(Decoder().decode_annexb(out))) == 3


def test_gop_idr_ids_distinct(fixtures_dir):
    """Back-to-back IDRs at GOP boundaries must carry distinct idr_pic_id
    (norm 7.4.3) in the sharded all-intra stream."""
    import jax

    from h264_fer.bitstream import nal as N
    from h264_fer.bitstream.bitio import BitReader
    from h264_fer.bitstream.params import PPS, SPS, SliceHeader
    from h264_fer.parallel.gop_device import GopIntraEncoder

    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:4]
    data = GopIntraEncoder(
        176, 144, 28, devices=jax.devices()[:2]).encode_sequence(frames)
    sps = pps = None
    ids = []
    for u in N.iter_nal_units(data):
        if u.nal_unit_type == N.NAL_SPS:
            sps = SPS.parse(BitReader(u.rbsp))
        elif u.nal_unit_type == N.NAL_PPS:
            pps = PPS.parse(BitReader(u.rbsp))
        elif u.nal_unit_type == N.NAL_IDR:
            sh = SliceHeader.parse(BitReader(u.rbsp), sps, pps,
                                   u.nal_unit_type, u.nal_ref_idc)
            ids.append(sh.idr_pic_id)
    assert len(ids) == 4
    for a, b in zip(ids, ids[1:]):
        assert a != b, ids


def test_multihost_single_process_ippp(fixtures_dir):
    import jax

    from h264_fer.codec.decoder import Decoder
    from h264_fer.parallel.dist import encode_multihost
    from h264_fer.parallel.gop_device import GopIpppEncoder

    frames = list(Y4MReader(str(fixtures_dir / "clip_qcif_10f.y4m")))[:4]
    out = encode_multihost(frames, 176, 144, qp=28, gop_len=2)
    ref = GopIpppEncoder(
        176, 144, 28, gop_len=2,
        devices=jax.local_devices()).encode_sequence(frames)
    assert out == ref
    assert len(list(Decoder().decode_annexb(out))) == 4
