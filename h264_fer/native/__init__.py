"""Native host-runtime extension (C++, ctypes-loaded).

Compiled on first import with g++ into a cached shared object; every
function has a pure-Python fallback (ops/cavlc.py, bitstream/), and tests
assert bit-identical behavior. Set H264_FER_NO_NATIVE=1 to disable.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "cavlc_native.cpp"
_SRC_DEC = _HERE / "decoder_native.cpp"
_SO = _HERE / "_cavlc_native.so"

_lib = None


def _build() -> None:
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-o", str(_SO), str(_SRC),
         str(_SRC_DEC)],
        check=True,
        capture_output=True,
    )


def get_lib():
    """Load (building if needed) the native library, or None if disabled or
    the toolchain is unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("H264_FER_NO_NATIVE"):
        return None
    try:
        newest = max(_SRC.stat().st_mtime, _SRC_DEC.stat().st_mtime)
        if not _SO.exists() or _SO.stat().st_mtime < newest:
            _build()
        lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.CalledProcessError):
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bitpack.restype = ctypes.c_long
    lib.bitpack.argtypes = [u32p, u8p, ctypes.c_long, u8p]
    lib.insert_epb.restype = ctypes.c_long
    lib.insert_epb.argtypes = [
        ctypes.c_char_p, ctypes.c_long, u8p,
    ]
    lib.cavlc_block_symbols.restype = ctypes.c_int
    lib.cavlc_block_symbols.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        u32p, u8p, ctypes.POINTER(ctypes.c_int),
    ]
    lib.decoder_init.restype = None
    lib.decoder_init.argtypes = [i32p] * 14
    lib.decode_slice.restype = ctypes.c_long
    lib.decode_slice.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        i32p, i32p,
        i32p, i32p, i32p,
        i32p, i32p, i32p,
        i32p, i32p, i32p, i32p, i32p, i32p,
        u8p, u8p, i32p,
    ]
    lib.i16_frame_entropy.restype = ctypes.c_long
    lib.i16_frame_entropy.argtypes = [
        i32p, i32p, i32p, i32p, i32p, i32p,
        ctypes.c_int, ctypes.c_int,
        i32p, i32p,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        u8p, i32p, i32p, i32p, i32p, i32p,
    ]
    _lib = lib
    return lib


# flattened, C-contiguous table copies for the native calls
_tables = None


def _get_tables():
    global _tables
    if _tables is None:
        from ..ops import cavlc_tables as T

        _tables = tuple(
            np.ascontiguousarray(a.reshape(-1), dtype=np.int32)
            for a in (
                T.COEFF_TOKEN_LEN, T.COEFF_TOKEN_BITS,
                T.TOTAL_ZEROS_LEN, T.TOTAL_ZEROS_BITS,
                T.TOTAL_ZEROS_CDC_LEN, T.TOTAL_ZEROS_CDC_BITS,
                T.RUN_BEFORE_LEN, T.RUN_BEFORE_BITS,
            )
        )
    return _tables


def block_symbols_native(levels, nc: int, max_num_coeff: int):
    """Native ops/cavlc.block_symbols: returns (symbols list, total_coeff)
    or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    lv = np.ascontiguousarray(levels, dtype=np.int32)
    vals = np.empty(80, np.uint32)
    lens = np.empty(80, np.uint8)
    tc = ctypes.c_int(0)
    n = lib.cavlc_block_symbols(
        lv, max_num_coeff, nc, *_get_tables(), vals, lens, ctypes.byref(tc)
    )
    return (
        [(int(vals[i]), int(lens[i])) for i in range(n)],
        int(tc.value),
    )


def bitpack_native(vals: np.ndarray, lens: np.ndarray) -> tuple[bytes, int]:
    """Pack (values, lengths) MSB-first. Returns (bytes, total_bits)."""
    lib = get_lib()
    assert lib is not None
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    lens = np.ascontiguousarray(lens, dtype=np.uint8)
    out = np.empty(int(lens.sum()) // 8 + 8, np.uint8)
    bits = lib.bitpack(vals, lens, len(vals), out)
    return out[: (bits + 7) // 8].tobytes(), int(bits)


_nbr_maps = None


def _get_nbr_maps():
    global _nbr_maps
    if _nbr_maps is None:
        from ..codec.decoder import _chroma_blk_neighbors, _luma_blk_neighbors

        luma = np.array([_luma_blk_neighbors(b) for b in range(16)], np.int32)
        chroma = np.array([_chroma_blk_neighbors(b) for b in range(4)], np.int32)
        _nbr_maps = (np.ascontiguousarray(luma), np.ascontiguousarray(chroma))
    return _nbr_maps


def i16_frame_entropy_native(mode16, cmode, i16dc, i16ac, cdc, cac,
                             wmb: int):
    """Whole-slice macroblock_layer entropy for an all-I16 device frame.

    Returns (rbsp_payload_bytes, nbits, mb_type, cbp_luma, cbp_chroma,
    tc_luma, tc_chroma) or None when the native lib is unavailable.
    The payload starts at bit 0; splice into the slice-header writer with
    BitWriter.append_bits.
    """
    lib = get_lib()
    if lib is None:
        return None
    nmb = len(mode16)
    c = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    mode16, cmode = c(mode16), c(cmode)
    i16dc, i16ac, cdc, cac = c(i16dc), c(i16ac), c(cdc), c(cac)
    luma_nbr, chroma_nbr = _get_nbr_maps()
    # worst-case CAVLC output per MB: 27 blocks × (16 coeff × 28-bit escape
    # levels + coeff_token + total_zeros + 15 run_before codes) ≈ 1950 bytes
    # ≤ the 2048 allocated (4:2:0-specific: re-derive if the block count per
    # MB ever changes)
    out = np.empty(nmb * 2048 + 4096, np.uint8)
    mb_type = np.zeros(nmb, np.int32)
    cbp_l = np.zeros(nmb, np.int32)
    cbp_c = np.zeros(nmb, np.int32)
    tc_luma = np.zeros(nmb * 16, np.int32)
    tc_chroma = np.zeros(2 * nmb * 4, np.int32)
    nbits = lib.i16_frame_entropy(
        mode16, cmode, i16dc.reshape(-1), i16ac.reshape(-1),
        cdc.reshape(-1), cac.reshape(-1), nmb, wmb,
        luma_nbr.reshape(-1), chroma_nbr.reshape(-1), *_get_tables(),
        out, mb_type, cbp_l, cbp_c, tc_luma, tc_chroma,
    )
    payload = out[: (nbits + 7) // 8].tobytes()
    return (payload, int(nbits), mb_type, cbp_l, cbp_c,
            tc_luma.reshape(nmb, 16), tc_chroma.reshape(2, nmb, 4))


def insert_epb_native(rbsp: bytes) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(rbsp) + len(rbsp) // 2 + 8, np.uint8)
    n = lib.insert_epb(rbsp, len(rbsp), out)
    return out[:n].tobytes()


_dec_init = False


def _decoder_tables():
    from ..ops import cavlc_tables as CT
    from ..ops import tables as TT
    from ..ops import transform as TR

    c = lambda a: np.ascontiguousarray(np.asarray(a).reshape(-1), np.int32)
    return (
        c(CT.COEFF_TOKEN_LEN), c(CT.COEFF_TOKEN_BITS),
        c(CT.TOTAL_ZEROS_LEN), c(CT.TOTAL_ZEROS_BITS),
        c(CT.TOTAL_ZEROS_CDC_LEN), c(CT.TOTAL_ZEROS_CDC_BITS),
        c(CT.RUN_BEFORE_LEN), c(CT.RUN_BEFORE_BITS),
        c(TT.CODENUM_TO_CBP_INTRA), c(TT.CODENUM_TO_CBP_INTER),
        c(TT.INTRA4X4_SCAN_ORDER_XY), c(TT.RASTER_TO_LUMA_BLOCK),
        c(TR.QPI_TO_QPC), c(TR.ZIGZAG_FLAT),
    )


def decode_slice_native(dec, rbsp: bytes, bit_pos: int, shd, spec_mode: bool):
    """Native whole-slice decode into the Decoder's state arrays.

    Returns the final qpy, or None when the native lib is unavailable.
    Raises ValueError on the same fail-fast syntax checks as the Python
    slice loop (decoder_native.cpp error codes)."""
    global _dec_init
    lib = get_lib()
    if lib is None:
        return None
    if not _dec_init:
        lib.decoder_init(*_decoder_tables())
        _dec_init = True
    data = np.frombuffer(rbsp, np.uint8)
    mbqpd = np.asarray([dec.mb_qp_delta], np.int32)
    qpy_out = np.zeros(1, np.int32)
    is_i = shd.slice_type % 5 == 2
    z32 = np.zeros(1, np.int32)  # placeholder ref for I slices
    ref_y = dec.ref_y if not is_i else z32
    ref_cb = dec.ref_cb if not is_i else z32
    ref_cr = dec.ref_cr if not is_i else z32
    res = lib.decode_slice(
        np.ascontiguousarray(data), len(rbsp), bit_pos,
        shd.slice_type, dec.qpy, dec.wmb, dec.hmb,
        dec.pps.chroma_qp_index_offset,
        int(dec.pps.constrained_intra_pred_flag),
        int(shd.num_ref_idx_active_override_flag),
        int(dec.pps.num_ref_idx_l0_active),
        int(shd.num_ref_idx_l0_active_minus1),
        int(spec_mode),
        mbqpd, dec.stale_chroma_ac.reshape(-1),
        dec.y.reshape(-1), dec.cb.reshape(-1), dec.cr.reshape(-1),
        np.ascontiguousarray(ref_y.reshape(-1)),
        np.ascontiguousarray(ref_cb.reshape(-1)),
        np.ascontiguousarray(ref_cr.reshape(-1)),
        dec.mb_type, dec.tc_luma.reshape(-1), dec.tc_chroma.reshape(-1),
        dec.i4x4_mode.reshape(-1), dec.mv.reshape(-1), dec.num_parts,
        dec.mb_intra.view(np.uint8), dec.mb_i4x4.view(np.uint8), qpy_out,
    )
    if res < 0:
        msgs = {
            -3: "bad mb_type",
            -4: "I_PCM not supported (matches reference)",
            -5: "bad intra_chroma_pred_mode",
            -6: "bad coded_block_pattern codeNum",
            -7: "bad mb_qp_delta",
            -8: "bad TotalCoeff",
            -9: "invalid VLC codeword",
            -10: "P slice without reference frame",
        }
        if res == -4:
            raise NotImplementedError(msgs[-4])
        raise ValueError(msgs.get(int(res), f"native decode error {res}"))
    dec.mb_qp_delta = int(mbqpd[0])
    return int(qpy_out[0])
