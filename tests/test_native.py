"""Native extension vs pure-Python bit-identity."""

import numpy as np
import pytest

from h264_fer.bitstream import nal
from h264_fer.bitstream.bitio import BitWriter
from h264_fer.native import (
    bitpack_native,
    block_symbols_native,
    get_lib,
    insert_epb_native,
)
from h264_fer.ops import cavlc

pytestmark = pytest.mark.skipif(get_lib() is None, reason="no native toolchain")


def test_block_symbols_bit_identical():
    rng = np.random.default_rng(11)
    for _ in range(800):
        maxc = int(rng.choice([4, 15, 16]))
        nc = -1 if maxc == 4 else int(rng.choice([0, 1, 2, 3, 5, 9]))
        levels = np.zeros(maxc, np.int64)
        nnz = int(rng.integers(0, maxc + 1))
        pos = rng.choice(maxc, nnz, replace=False)
        levels[pos] = rng.integers(-2000, 2000, nnz)
        levels[pos[levels[pos] == 0]] = 1
        py = cavlc.block_symbols(list(levels), nc, maxc)
        nat = block_symbols_native(levels, nc, maxc)
        assert py[0] == nat[0] and py[1] == nat[1]


def test_epb_bit_identical():
    rng = np.random.default_rng(12)
    for _ in range(300):
        data = bytes(rng.integers(0, 4, int(rng.integers(0, 64))).astype(np.uint8))
        # compare against the pure-python loop (bypass the native fast path)
        out = bytearray()
        zeros = 0
        for b in data:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        assert insert_epb_native(data) == bytes(out)


def test_bitpack_matches_bitwriter():
    rng = np.random.default_rng(13)
    lens = rng.integers(1, 25, 500).astype(np.uint8)
    vals = (rng.integers(0, 1 << 24, 500).astype(np.uint32)
            & ((1 << lens.astype(np.uint32)) - 1))
    w = BitWriter()
    for v, n in zip(vals, lens):
        w.write(int(v), int(n))
    nbits = w.bit_position
    w.write(0, (8 - nbits % 8) % 8)
    packed, bits = bitpack_native(vals, lens)
    assert bits == nbits
    assert packed == w.getvalue()


def _random_dev_i16(rng, nmb):
    """Random but CAVLC-valid device-path level arrays for nmb MBs."""
    def levels(shape, maxc):
        out = np.zeros(shape + (maxc,), np.int32)
        flat = out.reshape(-1, maxc)
        for row in flat:
            nnz = int(rng.integers(0, maxc + 1))
            if rng.random() < 0.3:
                nnz = 0  # plenty of all-zero blocks (CBP gating paths)
            pos = rng.choice(maxc, nnz, replace=False)
            v = rng.integers(-500, 500, nnz)
            v[v == 0] = 1
            row[pos] = v
        return out

    return {
        "mode16": rng.integers(0, 4, nmb).astype(np.int32),
        "cmode": rng.integers(0, 4, nmb).astype(np.int32),
        "i16dc": levels((nmb,), 16),
        "i16ac": levels((nmb, 16), 15),
        "cdc": levels((2, nmb), 4),
        "cac": levels((2, nmb, 4), 15),
    }


@pytest.mark.parametrize("offset_bits", [0, 3, 8, 13])
def test_i16_frame_entropy_matches_per_mb_device_path(offset_bits):
    """Whole-slice native entropy == the Python _intra_encode_mb_device
    loop, byte-for-byte at odd splice offsets, with identical write-back
    state."""
    from h264_fer.bitstream.params import I_SLICE
    from h264_fer.codec.encoder import Encoder, EncoderConfig

    rng = np.random.default_rng(21)
    wmb, hmb = 4, 3
    nmb = wmb * hmb
    dev = _random_dev_i16(rng, nmb)

    def fresh():
        e = Encoder(wmb * 16, hmb * 16, EncoderConfig(qp=28))
        e.slice_type = I_SLICE
        e._dev_i16 = dev
        return e

    # Python per-MB reference path
    e_py = fresh()
    w_py = BitWriter()
    w_py.write((1 << offset_bits) - 1, offset_bits)
    for curr in range(nmb):
        e_py._intra_encode_mb_device(w_py, curr)
    nbits_py = w_py.bit_position
    w_py.write(0, (8 - nbits_py % 8) % 8)

    # native whole-slice path
    e_nat = fresh()
    w_nat = BitWriter()
    w_nat.write((1 << offset_bits) - 1, offset_bits)
    assert e_nat._intra_encode_frame_native(w_nat)
    nbits_nat = w_nat.bit_position
    w_nat.write(0, (8 - nbits_nat % 8) % 8)

    assert nbits_nat == nbits_py
    assert w_nat.getvalue() == w_py.getvalue()
    np.testing.assert_array_equal(e_nat.mb_type, e_py.mb_type)
    np.testing.assert_array_equal(e_nat.cbp_luma, e_py.cbp_luma)
    np.testing.assert_array_equal(e_nat.cbp_chroma, e_py.cbp_chroma)
    np.testing.assert_array_equal(e_nat.tc_luma, e_py.tc_luma)
    np.testing.assert_array_equal(e_nat.tc_chroma, e_py.tc_chroma)
    np.testing.assert_array_equal(e_nat.nz_luma, e_py.nz_luma)
