"""Bitstream layer tests: bit IO, Exp-Golomb, NAL framing, parameter sets.

Golden oracle: the SPS/PPS at the head of the reference's own test stream
`drugi.264`, and byte-identity of our re-serialized parameter sets.
"""

import pathlib

import numpy as np
import pytest

from h264_fer.bitstream import nal as nal_mod
from h264_fer.bitstream.bitio import BitReader, BitWriter
from h264_fer.bitstream.expgolomb import read_se, read_ue, write_se, write_ue
from h264_fer.bitstream.params import PPS, SPS, SliceHeader

DRUGI = pathlib.Path("/root/reference/fer_h264/fer_h264/drugi.264")


def test_bitio_roundtrip():
    rng = np.random.default_rng(1)
    fields = [(int(rng.integers(0, 1 << n)), n) for n in rng.integers(1, 25, 200)]
    w = BitWriter()
    for v, n in fields:
        w.write(v, n)
    w.rbsp_trailing_bits()
    r = BitReader(w.getvalue())
    for v, n in fields:
        assert r.read(n) == v
    assert r.read_bit() == 1  # stop bit


def test_expgolomb_roundtrip():
    w = BitWriter()
    for v in range(0, 300):
        write_ue(w, v)
    for v in range(-150, 150):
        write_se(w, v)
    w.rbsp_trailing_bits()
    r = BitReader(w.getvalue())
    for v in range(0, 300):
        assert read_ue(r) == v
    for v in range(-150, 150):
        assert read_se(r) == v


def test_expgolomb_known_codes():
    # norm 9.1 table: codeNum 0→'1', 1→'010', 2→'011', 3→'00100'
    w = BitWriter()
    for v in [0, 1, 2, 3]:
        write_ue(w, v)
    w.write(0, 4)  # pad to byte: 1+3+3+5+4 = 16 bits
    r = BitReader(w.getvalue())
    assert r.read(1) == 0b1
    assert r.read(3) == 0b010
    assert r.read(3) == 0b011
    assert r.read(5) == 0b00100


def test_emulation_prevention_roundtrip():
    cases = [
        b"\x00\x00\x00",
        b"\x00\x00\x01\x00\x00\x02",
        b"\x00\x00\x03\x00\x00",
        b"\x12\x00\x00\x00\x00\x01",
        bytes(range(256)) + b"\x00\x00\x00\x00",
    ]
    for rbsp in cases:
        ebsp = nal_mod.insert_emulation_prevention(rbsp)
        # no forbidden pattern remains
        for i in range(len(ebsp) - 2):
            assert not (ebsp[i] == 0 and ebsp[i + 1] == 0 and ebsp[i + 2] <= 3 and ebsp[i + 2] != 3)
        assert nal_mod.remove_emulation_prevention(ebsp) == rbsp


@pytest.mark.skipif(not DRUGI.exists(), reason="reference stream not mounted")
def test_parse_drugi_headers():
    """drugi.264 is a third-party Baseline stream (VUI present, deblocking
    control flags present) the reference ships as a decoder fixture — parse
    its headers and first slice header."""
    data = DRUGI.read_bytes()
    units = nal_mod.iter_nal_units(data)
    sps_unit = next(units)
    assert sps_unit.nal_unit_type == nal_mod.NAL_SPS
    sps = SPS.parse(BitReader(sps_unit.rbsp))
    assert sps.profile_idc == 66
    assert (sps.width, sps.height) == (640, 480)
    assert sps.max_num_ref_frames == 1
    assert sps.frame_mbs_only_flag == 1
    assert sps.vui_parameters_present_flag == 1  # parsed-then-ignored, like the reference

    pps_unit = next(units)
    assert pps_unit.nal_unit_type == nal_mod.NAL_PPS
    pps = PPS.parse(BitReader(pps_unit.rbsp))
    assert pps.entropy_coding_mode_flag == 0  # CAVLC
    assert pps.num_slice_groups == 1
    assert pps.deblocking_filter_control_present_flag == 1

    # drugi.264 carries an x264 SEI ("x264 - core 36") before the IDR —
    # skip non-slice NALs as the reference decoder does (rbsp_decoding.cpp).
    sl = next(units)
    while sl.nal_unit_type not in (nal_mod.NAL_IDR, nal_mod.NAL_NOT_IDR):
        sl = next(units)
    assert sl.nal_unit_type == nal_mod.NAL_IDR
    r = BitReader(sl.rbsp)
    shd = SliceHeader.parse(r, sps, pps, sl.nal_unit_type, sl.nal_ref_idc)
    assert shd.first_mb_in_slice == 0
    assert shd.slice_type % 5 == 2  # I slice


def test_reference_encoder_fixture_headers(fixtures_dir):
    """Headers of a stream produced by the reference encoder itself must
    re-serialize byte-identically (including its weighted_bipred PPS quirk,
    headers_and_parameter_sets.cpp:504)."""
    data = (fixtures_dir / "ref_qcif_intra_qp28.264").read_bytes()
    units = nal_mod.iter_nal_units(data)
    sps_unit = next(units)
    sps = SPS.parse(BitReader(sps_unit.rbsp))
    assert sps.profile_idc == 66 and sps.level_idc == 41
    assert (sps.width, sps.height) == (176, 144)
    assert sps.log2_max_frame_num == 9
    assert sps.log2_max_pic_order_cnt_lsb == 10
    w = BitWriter()
    sps.write(w)
    w.rbsp_trailing_bits()
    assert w.getvalue() == sps_unit.rbsp

    pps_unit = next(units)
    pps = PPS.parse(BitReader(pps_unit.rbsp))
    assert pps.pic_init_qp == 14 + 28  # pic_init_qp = 14 + qp
    assert pps.weighted_bipred_idc == 1  # the reference quirk on the wire
    w = BitWriter()
    pps.write(w)
    w.rbsp_trailing_bits()
    assert w.getvalue() == pps_unit.rbsp

    # IDR slice header: parse + re-serialize bit-exactly
    sl = next(units)
    assert sl.nal_unit_type == nal_mod.NAL_IDR
    r = BitReader(sl.rbsp)
    shd = SliceHeader.parse(r, sps, pps, sl.nal_unit_type, sl.nal_ref_idc)
    assert shd.slice_type % 5 == 2
    assert shd.slice_qp_delta == -14  # SliceQPy = pic_init_qp - 14 = qp
    assert shd.slice_qp_y(pps) == 28
    header_bits = r.bit_position
    w = BitWriter()
    shd.write(w, sps, pps, sl.nal_unit_type, sl.nal_ref_idc)
    assert w.bit_position == header_bits
    rr = BitReader(sl.rbsp)
    prefix = [rr.read_bit() for _ in range(header_bits)]
    w.rbsp_trailing_bits()
    rw = BitReader(w.getvalue())
    assert [rw.read_bit() for _ in range(header_bits)] == prefix


@pytest.mark.skipif(not DRUGI.exists(), reason="reference stream not mounted")
def test_nal_reframing_identity():
    """Re-framing every NAL of drugi.264 reproduces the file byte-for-byte."""
    data = DRUGI.read_bytes()
    out = bytearray()
    for u in nal_mod.iter_nal_units(data):
        out += nal_mod.write_nal_unit(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
    assert bytes(out) == data
