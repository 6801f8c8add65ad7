"""H.264 Baseline decoder (host orchestration + batched NumPy reconstruction).

Bit-exact re-implementation of the reference decoder's behavior
(rbsp_decoding.cpp:17-367), including its deliberate deviations from the
norm where they affect output:

- `more_rbsp_data` is the byte-count approximation (rbsp_IO.cpp:193).
- mb_qp_delta is a *persistent* variable: the QPy update runs for skipped
  and residual-free MBs using the stale value (rbsp_decoding.cpp:111,322).
- Sub-8x8 partition MVs are collapsed to the 8x8 partition MV after
  prediction (mode_pred.cpp DeriveMVs:470-482 copies [i][0] over [i][j]).
- The half-pel filter chains clipped intermediates for the center positions
  (mocomp.cpp Tap6Filter on already-Bordered values).
- No deblocking (reference has none); decode of our deblocking-enabled
  streams applies the filter only when the stream signals it.

This is the conformance oracle counterpart: output must equal the reference
decoder's YUV byte-for-byte (tests/test_decoder.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitReader
from ..bitstream.expgolomb import read_se, read_te, read_ue
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader
from ..ops import cavlc, intra, mc, transform
from . import mvpred
from ..ops import tables as T

# Unified mb classification
INTER_TYPES = ("P16x16", "P16x8", "P8x16", "P8x8", "P8x8REF0")
MB_SKIP = -2


@dataclass
class MbClass:
    is_intra: bool
    is_i4x4: bool = False
    is_i16x16: bool = False
    i16_mode: int = 0
    cbp_luma_fixed: int | None = None  # for I16x16
    cbp_chroma_fixed: int | None = None
    num_parts: int = 1
    part_w: int = 16
    part_h: int = 16


def classify_mb(mb_type: int, slice_type: int) -> MbClass:
    """Decode raw mb_type per norm Tables 7-11/7-13 (h264_globals.cpp:25-132)."""
    if slice_type % 5 == P_SLICE:
        if mb_type < 5:
            widths = [(1, 16, 16), (2, 16, 8), (2, 8, 16), (4, 8, 8), (4, 8, 8)]
            n, w, h = widths[mb_type]
            return MbClass(False, num_parts=n, part_w=w, part_h=h)
        i_type = mb_type - 5
    else:
        i_type = mb_type
    if i_type == 0:
        return MbClass(True, is_i4x4=True)
    if i_type == 25:
        raise NotImplementedError("I_PCM not supported (matches reference)")
    n = i_type - 1
    return MbClass(
        True,
        is_i16x16=True,
        i16_mode=n % 4,
        cbp_chroma_fixed=(n // 4) % 3,
        cbp_luma_fixed=15 if n >= 12 else 0,
    )


# Z-scan luma block geometry
_BLK_XY = T.INTRA4X4_SCAN_ORDER_XY  # (16, 2): x, y pixel offsets
_RASTER_TO_Z = T.RASTER_TO_LUMA_BLOCK  # raster index -> Z index


def _z_of_raster(bx: int, by: int) -> int:
    return int(_RASTER_TO_Z[by * 4 + bx])


def _luma_blk_neighbors(blk: int):
    """(A_same_mb, A_blk, B_same_mb, B_blk) for Z-scan block `blk`
    (reference subMBNeighbours + derivation, residual.cpp:251-294)."""
    bx = int(_BLK_XY[blk, 0]) // 4
    by = int(_BLK_XY[blk, 1]) // 4
    a_same = bx > 0
    a_blk = _z_of_raster((bx - 1) % 4, by)
    b_same = by > 0
    b_blk = _z_of_raster(bx, (by - 1) % 4)
    return a_same, a_blk, b_same, b_blk


def _chroma_blk_neighbors(blk: int):
    bx, by = blk % 2, blk // 2
    a_same = bx > 0
    a_blk = by * 2 + (bx - 1) % 2
    b_same = by > 0
    b_blk = ((by - 1) % 2) * 2 + bx
    return a_same, a_blk, b_same, b_blk


class Decoder:
    """Stateful session decoder mirroring the reference's global state."""

    def __init__(self, deblock: bool = False) -> None:
        """`deblock`: apply the in-loop filter when the stream signals it.
        Default False = reference-decoder behavior (it has no filter), which
        keeps bit-exactness with refdec on any stream it accepts."""
        self.deblock = deblock
        self.sps: SPS | None = None
        self.pps: PPS | None = None
        self.mb_qp_delta = 0  # persistent across MBs/frames (reference quirk)
        self.frame_count = 0
        self._alloc_done = False

    # -- frame geometry ----------------------------------------------------
    def _alloc(self) -> None:
        sps = self.sps
        self.wmb = sps.pic_width_in_mbs
        self.hmb = sps.pic_height_in_map_units
        self.nmb = self.wmb * self.hmb
        w, h = self.wmb * 16, self.hmb * 16
        self.y = np.zeros((h, w), np.int32)
        self.cb = np.zeros((h // 2, w // 2), np.int32)
        self.cr = np.zeros((h // 2, w // 2), np.int32)
        self.ref_y = None  # DPB depth 1 (ref_frames.cpp:14)
        self.ref_cb = None
        self.ref_cr = None
        # Persistent chroma-AC state replicating the reference quirk:
        # clear_residual_structures (residual.cpp:28-49) zeroes every level
        # array EXCEPT ChromaACLevel, so non-skip CBP==0 macroblocks re-apply
        # the stale chroma AC residual of the last residual-carrying MB
        # (P_Skip passes local zero arrays, transformDecodingP_Skip,
        # inttransform.cpp:215-229, and is unaffected).
        self.stale_chroma_ac = np.zeros((2, 4, 15), np.int32)
        self.mb_type = np.zeros(self.nmb, np.int32)  # raw slice mb_type / MB_SKIP
        self.mb_intra = np.zeros(self.nmb, bool)
        self.mb_i4x4 = np.zeros(self.nmb, bool)
        self.tc_luma = np.zeros((self.nmb, 16), np.int32)
        self.tc_chroma = np.zeros((2, self.nmb, 4), np.int32)
        self.i4x4_mode = np.zeros((self.nmb, 16), np.int32)
        self.mv = np.zeros((self.nmb, 4, 4, 2), np.int32)
        self.num_parts = np.ones(self.nmb, np.int32)
        self._alloc_done = True

    # -- public API --------------------------------------------------------
    def decode_annexb(self, data: bytes):
        """Yield (y, cb, cr) uint8 frames for an Annex-B stream."""
        for u in nal_mod.iter_nal_units(data):
            fr = self.decode_nal(u)
            if fr is not None:
                yield fr

    def decode_nal(self, u: nal_mod.NalUnit):
        if u.nal_unit_type == nal_mod.NAL_SPS:
            self.sps = SPS.parse(BitReader(u.rbsp))
            self._alloc()
            return None
        if u.nal_unit_type == nal_mod.NAL_PPS:
            self.pps = PPS.parse(BitReader(u.rbsp))
            return None
        if u.nal_unit_type in (nal_mod.NAL_IDR, nal_mod.NAL_NOT_IDR):
            return self._decode_slice(u)
        return None  # SEI etc: ignored like the reference

    # -- slice decode ------------------------------------------------------
    def _decode_slice(self, u: nal_mod.NalUnit):
        self.frame_count += 1
        r = BitReader(u.rbsp)
        shd = SliceHeader.parse(r, self.sps, self.pps, u.nal_unit_type, u.nal_ref_idc)
        self.shd = shd
        # Spec-correct mode for deblock-signaled slices we filter: such
        # streams cannot come from the reference (it has no filter), so the
        # stale-ChromaACLevel quirk must NOT apply (the producing encoder
        # reconstructs with clean zero levels).
        self._spec_mode = bool(
            self.deblock
            and self.pps.deblocking_filter_control_present_flag
            and shd.disable_deblocking_filter_idc != 1
        )
        slice_type = shd.slice_type
        qpy = shd.slice_qp_y(self.pps)
        self.qpy = qpy

        # Native fast path: the whole scalar-sequential slice loop (CAVLC
        # parse + prediction + reconstruction) in C++
        # (native/decoder_native.cpp), writing the same state arrays.
        # Python below remains the semantic reference and the fallback
        # (H264_FER_NO_NATIVE=1); tests assert identical planes.
        from ..native import decode_slice_native

        qpy_native = decode_slice_native(
            self, u.rbsp, r.bit_position, shd, self._spec_mode)
        if qpy_native is not None:
            self.qpy = qpy_native
            return self._finish_frame(shd)

        # P slices: precompute 16-phase interpolated reference planes once
        # per frame (bit-identical to per-window MC; ops/interp.py) — large
        # MVs beyond the padded extent fall back to the window path.
        if slice_type % 5 != I_SLICE and self.ref_y is not None:
            from ..ops.interp import LazyInterpPlanes, pad_chroma

            self._interp_ext = 40
            self._interp = LazyInterpPlanes(self.ref_y, ext=self._interp_ext)
            self._interp_extc = self._interp_ext // 2 + 1
            self._interp_cb = pad_chroma(self.ref_cb, self._interp_extc)
            self._interp_cr = pad_chroma(self.ref_cr, self._interp_extc)
        else:
            self._interp = None

        curr = 0
        more_data = True
        while more_data and curr < self.nmb:
            if slice_type % 5 != I_SLICE:
                skip_run = read_ue(r)
                for _ in range(skip_run):
                    if curr >= self.nmb:
                        break
                    self._decode_skip_mb(curr)
                    curr += 1
                if curr != 0 or skip_run > 0:
                    more_data = r.more_rbsp_data()
            if more_data:
                self._decode_mb(r, curr, slice_type)
                more_data = r.more_rbsp_data()
                curr += 1

        return self._finish_frame(shd)

    def _finish_frame(self, shd):
        if (
            self.deblock
            and self.pps.deblocking_filter_control_present_flag
            and shd.disable_deblocking_filter_idc != 1
        ):
            from .loopfilter import deblock_frame

            self.nz_luma = self.tc_luma > 0
            self.qpc = transform.chroma_qp(self.qpy, self.pps.chroma_qp_index_offset)
            deblock_frame(self)
        # DPB update: single-frame deep copy (ref_frames.cpp:17-35,93-183)
        self.ref_y = self.y.copy()
        self.ref_cb = self.cb.copy()
        self.ref_cr = self.cr.copy()
        return (
            self.y.astype(np.uint8),
            self.cb.astype(np.uint8),
            self.cr.astype(np.uint8),
        )

    def _mc_mb(self, curr: int):
        mv = self.mv[curr]
        if self._interp is not None and np.abs(mv).max() <= self._interp_ext * 4 - 4:
            from ..ops.interp import mc_macroblock_from_planes

            return mc_macroblock_from_planes(
                self._interp, self._interp_cb, self._interp_cr,
                curr % self.wmb, curr // self.wmb, mv,
                self._interp_ext, self._interp_extc,
            )
        return mc.mc_macroblock(
            self.ref_y, self.ref_cb, self.ref_cr,
            curr % self.wmb, curr // self.wmb, mv,
        )

    # -- P_Skip ------------------------------------------------------------
    def _decode_skip_mb(self, curr: int) -> None:
        self.mb_type[curr] = MB_SKIP
        self.mb_intra[curr] = False
        self.mb_i4x4[curr] = False
        self.num_parts[curr] = 1
        self.tc_luma[curr] = 0
        self.tc_chroma[:, curr] = 0
        self._derive_skip_mv(curr)
        pred_l, pred_cb, pred_cr = self._mc_mb(curr)
        # QPy update with (possibly stale) mb_qp_delta (rbsp_decoding.cpp:111)
        self.qpy = (self.qpy + self.mb_qp_delta + 52) % 52
        self._reconstruct_inter(
            curr, pred_l, pred_cb, pred_cr,
            luma_levels=np.zeros((16, 16), np.int32),
            chroma_dc=np.zeros((2, 4), np.int32),
            chroma_ac=np.zeros((2, 4, 15), np.int32),
            cbp_luma=0,
        )

    # -- full MB -----------------------------------------------------------
    def _decode_mb(self, r: BitReader, curr: int, slice_type: int) -> None:
        mb_type = read_ue(r)
        if mb_type > 31 or (slice_type % 5 == I_SLICE and mb_type > 24):
            raise ValueError(f"bad mb_type {mb_type} at MB {curr}")
        cls = classify_mb(mb_type, slice_type)
        self.mb_type[curr] = mb_type
        self.mb_intra[curr] = cls.is_intra
        self.mb_i4x4[curr] = cls.is_i4x4
        self.num_parts[curr] = cls.num_parts

        sub_mb_type = [0] * 4
        mvd = np.zeros((4, 4, 2), np.int32)
        prev_mode_flag = [False] * 16
        rem_mode = [0] * 16
        chroma_mode = 0

        if (not cls.is_intra) and cls.num_parts == 4:
            # sub_mb_pred (rbsp_decoding.cpp:145-176)
            for p in range(4):
                sub_mb_type[p] = read_ue(r)
            for p in range(4):
                if self.shd.num_ref_idx_active_override_flag > 0 and mb_type != 4:
                    read_te(r, self.pps.num_ref_idx_l0_active)  # ref_idx, ignored
            for p in range(4):
                for sp in range(int(T.SUB_MB_NUM_PARTS[sub_mb_type[p]])):
                    mvd[p, sp, 0] = read_se(r)
                    mvd[p, sp, 1] = read_se(r)
        elif cls.is_intra:
            if cls.is_i4x4:
                for b in range(16):
                    prev_mode_flag[b] = bool(r.read_bit())
                    if not prev_mode_flag[b]:
                        rem_mode[b] = r.read(3)
            chroma_mode = read_ue(r)
            if chroma_mode > 3:
                raise ValueError(f"bad intra_chroma_pred_mode {chroma_mode}")
        else:
            for p in range(cls.num_parts):
                if self.shd.num_ref_idx_l0_active_minus1 > 0:
                    read_te(r, self.pps.num_ref_idx_l0_active)
            for p in range(cls.num_parts):
                mvd[p, 0, 0] = read_se(r)
                mvd[p, 0, 1] = read_se(r)

        # CBP (rbsp_decoding.cpp:240-296)
        if not cls.is_i16x16:
            code_num = read_ue(r)
            if code_num > 47:
                raise ValueError(f"bad coded_block_pattern codeNum {code_num}")
            if cls.is_i4x4:
                cbp = int(T.CODENUM_TO_CBP_INTRA[code_num])
            else:
                cbp = int(T.CODENUM_TO_CBP_INTER[code_num])
            cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        else:
            cbp_luma = cls.cbp_luma_fixed
            cbp_chroma = cls.cbp_chroma_fixed
        self._cbp_luma = cbp_luma
        self._cbp_chroma = cbp_chroma

        # residual
        i16dc = np.zeros(16, np.int32)
        luma_levels = np.zeros((16, 16), np.int32)  # AC lists for i16, else full
        chroma_dc = np.zeros((2, 4), np.int32)
        if cbp_luma > 0 or cbp_chroma > 0 or cls.is_i16x16:
            self.mb_qp_delta = read_se(r)
            if not (-27 < self.mb_qp_delta < 26):
                raise ValueError(f"bad mb_qp_delta {self.mb_qp_delta}")
            self._parse_residual(
                r, curr, cls, cbp_luma, cbp_chroma, i16dc, luma_levels,
                chroma_dc, self.stale_chroma_ac,
            )
        else:
            # clear_residual_structures: chroma AC stays STALE (see _alloc) —
            # except in spec mode (deblock-signaled streams), where absent
            # residual means zero levels
            self.tc_luma[curr] = 0
            self.tc_chroma[:, curr] = 0
            if self._spec_mode:
                self.stale_chroma_ac[:] = 0
        chroma_ac = self.stale_chroma_ac

        self.qpy = (self.qpy + self.mb_qp_delta + 52) % 52

        # prediction + reconstruction
        if cls.is_intra:
            self._reconstruct_intra(
                curr, cls, prev_mode_flag, rem_mode, chroma_mode,
                i16dc, luma_levels, chroma_dc, chroma_ac, cbp_luma,
            )
        else:
            self._derive_inter_mv(curr, mb_type, cls, sub_mb_type, mvd)
            pred_l, pred_cb, pred_cr = self._mc_mb(curr)
            self._reconstruct_inter(
                curr, pred_l, pred_cb, pred_cr, luma_levels, chroma_dc,
                chroma_ac, cbp_luma,
            )

    # -- residual parsing (residual.cpp:959-1066) --------------------------
    def _parse_residual(self, r, curr, cls, cbp_luma, cbp_chroma, i16dc,
                        luma_levels, chroma_dc, chroma_ac) -> None:
        if cls.is_i16x16:
            levels, tc = cavlc.decode_residual_block(
                r, self._nc_luma(curr, 0), 0, 15, 16
            )
            i16dc[:] = levels
            self.tc_luma[curr, 0] = tc
        for i8 in range(4):
            for i4 in range(4):
                blk = i8 * 4 + i4
                if cbp_luma & (1 << i8):
                    if cls.is_i16x16:
                        levels, tc = cavlc.decode_residual_block(
                            r, self._nc_luma(curr, blk), 0, 14, 15
                        )
                        luma_levels[blk, :15] = levels
                    else:
                        levels, tc = cavlc.decode_residual_block(
                            r, self._nc_luma(curr, blk), 0, 15, 16
                        )
                        luma_levels[blk] = levels
                    self.tc_luma[curr, blk] = tc
                else:
                    self.tc_luma[curr, blk] = 0
        for c in range(2):
            if cbp_chroma & 3:
                levels, _ = cavlc.decode_residual_block(r, -1, 0, 3, 4)
                chroma_dc[c] = levels
        for c in range(2):
            for blk in range(4):
                if cbp_chroma & 2:
                    levels, tc = cavlc.decode_residual_block(
                        r, self._nc_chroma(curr, c, blk), 0, 14, 15
                    )
                    chroma_ac[c, blk] = levels
                    self.tc_chroma[c, curr, blk] = tc
                else:
                    chroma_ac[c, blk] = 0  # residual() zeroes parsed-path AC
                    self.tc_chroma[c, curr, blk] = 0

    # -- nC derivation (residual.cpp:1090-1185) ----------------------------
    def _nc_pair(self, curr, a_same, a_blk, b_same, b_blk, tc_arr, left_edge,
                 top_edge):
        nA = nB = None
        if a_same:
            nA = int(tc_arr[curr, a_blk])
        elif not left_edge:
            nA = int(tc_arr[curr - 1, a_blk])
        if b_same:
            nB = int(tc_arr[curr, b_blk])
        elif not top_edge:
            nB = int(tc_arr[curr - self.wmb, b_blk])
        if nA is not None and nB is not None:
            return (nA + nB + 1) >> 1
        if nA is not None:
            return nA
        if nB is not None:
            return nB
        return 0

    def _nc_luma(self, curr: int, blk: int) -> int:
        a_same, a_blk, b_same, b_blk = _luma_blk_neighbors(blk)
        return self._nc_pair(
            curr, a_same, a_blk, b_same, b_blk, self.tc_luma,
            curr % self.wmb == 0, curr < self.wmb,
        )

    def _nc_chroma(self, curr: int, c: int, blk: int) -> int:
        a_same, a_blk, b_same, b_blk = _chroma_blk_neighbors(blk)
        return self._nc_pair(
            curr, a_same, a_blk, b_same, b_blk, self.tc_chroma[c],
            curr % self.wmb == 0, curr < self.wmb,
        )

    # -- MV derivation: shared logic in mvpred.py --------------------------
    def _derive_skip_mv(self, curr: int) -> None:
        """PredictMV P_Skip rule (mode_pred.cpp:381-406)."""
        mv = mvpred.derive_skip_mv(self, curr)
        self.mv[curr, :, :, 0] = mv[0]
        self.mv[curr, :, :, 1] = mv[1]

    def _derive_inter_mv(self, curr, mb_type, cls, sub_mb_type, mvd) -> None:
        """PredictMV + DeriveMVs for non-skip inter MBs
        (mode_pred.cpp:408-483). Sub-8x8 MVs collapse to the 8x8 MV
        (reference quirk)."""
        part_mv = np.zeros((4, 2), np.int32)
        for p in range(cls.num_parts):
            px, py = mvpred.predict_mv_luma(
                self, curr, mb_type, cls.num_parts, p, sub_mb_type)
            part_mv[p, 0] = px + int(mvd[p, 0, 0])
            part_mv[p, 1] = py + int(mvd[p, 0, 1])
            # store incrementally: later partitions may reference earlier ones
            mvpred.store_part_mvs(self, curr, mb_type, cls.num_parts, part_mv, p)
        mvpred.store_part_mvs(
            self, curr, mb_type, cls.num_parts, part_mv, cls.num_parts - 1)
        mvpred.fan_out(self, curr)

    # -- reconstruction ----------------------------------------------------
    def _mb_origin(self, curr: int):
        return (curr % self.wmb) * 16, (curr // self.wmb) * 16

    def _reconstruct_inter(self, curr, pred_l, pred_cb, pred_cr, luma_levels,
                           chroma_dc, chroma_ac, cbp_luma) -> None:
        """Inter luma: per-4x4 inverse residual + clip (8.5.1);
        chroma per 8.5.4. All-zero levels (P_Skip and residual-less MBs,
        the common case) short-circuit to clip(pred) —
        transformDecodingP_Skip semantics, identical output."""
        x0, y0 = self._mb_origin(curr)
        qpy = self.qpy
        if cbp_luma == 0 or not luma_levels.any():
            out = pred_l  # MC output is already clipped (interp planes)
        else:
            blocks = transform.zigzag_unscan(luma_levels)  # (16, 4, 4)
            res = transform.inverse_residual(blocks, qpy, False)
            recon = np.zeros((16, 16), np.int32)
            for blk in range(16):
                bx = int(_BLK_XY[blk, 0])
                by = int(_BLK_XY[blk, 1])
                recon[by : by + 4, bx : bx + 4] = res[blk]
            out = np.clip(pred_l + recon, 0, 255)
        self.y[y0 : y0 + 16, x0 : x0 + 16] = out
        self._reconstruct_chroma(curr, pred_cb, pred_cr, chroma_dc, chroma_ac)

    def _reconstruct_chroma(self, curr, pred_cb, pred_cr, chroma_dc,
                            chroma_ac) -> None:
        """transformDecodingChroma (inttransform.cpp:237-321) per channel."""
        x0, y0 = self._mb_origin(curr)
        ys, xs = slice(y0 // 2, y0 // 2 + 8), slice(x0 // 2, x0 // 2 + 8)
        if not (chroma_dc.any() or chroma_ac.any()):
            self.cb[ys, xs] = pred_cb  # bilinear of clipped stays in range
            self.cr[ys, xs] = pred_cr
            return
        qpc = transform.chroma_qp(self.qpy, self.pps.chroma_qp_index_offset)
        # batched over both channels x 4 blocks (8 inverse transforms at once)
        dcv = transform.inverse_dc_chroma(chroma_dc.reshape(2, 2, 2), qpc)
        lists = np.empty((2, 4, 16), np.int32)
        lists[:, :, 0] = dcv.reshape(2, 4)
        lists[:, :, 1:] = chroma_ac
        res = transform.inverse_residual(
            transform.zigzag_unscan(lists), qpc, True
        )
        for c, (pred, plane) in enumerate(
            ((pred_cb, self.cb), (pred_cr, self.cr))
        ):
            rmb = np.zeros((8, 8), np.int32)
            for blk in range(4):
                bx, by = (blk % 2) * 4, (blk // 2) * 4
                rmb[by : by + 4, bx : bx + 4] = res[c, blk]
            out = np.clip(pred + rmb, 0, 255)
            plane[ys, xs] = out

    def _reconstruct_intra(self, curr, cls, prev_mode_flag, rem_mode,
                           chroma_mode, i16dc, luma_levels, chroma_dc,
                           chroma_ac, cbp_luma) -> None:
        x0, y0 = self._mb_origin(curr)
        qpy = self.qpy
        if cls.is_i4x4:
            # residuals are neighbor-independent: one batched inverse
            # transform for all 16 blocks; only predict+add interleaves
            # per block (intra.cpp:770-797)
            res16 = transform.inverse_residual(
                transform.zigzag_unscan(luma_levels), qpy, False)
            for blk in range(16):
                mode = self._derive_i4x4_mode(curr, blk, prev_mode_flag[blk],
                                              rem_mode[blk])
                self.i4x4_mode[curr, blk] = mode
                p = self._fetch_p13(curr, blk)
                pred = intra.predict_4x4(p, mode)
                bx = int(_BLK_XY[blk, 0])
                by = int(_BLK_XY[blk, 1])
                out = np.clip(pred + res16[blk], 0, 255)
                self.y[y0 + by : y0 + by + 4, x0 + bx : x0 + bx + 4] = out
        else:
            p33 = self._fetch_p33(curr)
            pred = intra.predict_16x16(p33, cls.i16_mode)
            # DC Hadamard + AC per 8.5.2 (inttransform.cpp:157-208),
            # batched over the 16 blocks
            dcblk = transform.zigzag_unscan(i16dc)
            dcv = transform.inverse_dc_luma(dcblk, qpy)
            bxs = _BLK_XY[:, 0] >> 2
            bys = _BLK_XY[:, 1] >> 2
            lists = np.empty((16, 16), np.int32)
            lists[:, 0] = dcv[bys, bxs]
            lists[:, 1:] = luma_levels[:, :15]
            res16 = transform.inverse_residual(
                transform.zigzag_unscan(lists), qpy, True)
            recon = np.zeros((16, 16), np.int32)
            for blk in range(16):
                bx = int(_BLK_XY[blk, 0])
                by = int(_BLK_XY[blk, 1])
                recon[by : by + 4, bx : bx + 4] = res16[blk]
            out = np.clip(pred + recon, 0, 255)
            self.y[y0 : y0 + 16, x0 : x0 + 16] = out

        pcb, pcr = self._fetch_p17(curr)
        pred_cb = intra.predict_chroma(pcb, chroma_mode)
        pred_cr = intra.predict_chroma(pcr, chroma_mode)
        self._reconstruct_chroma(curr, pred_cb, pred_cr, chroma_dc, chroma_ac)

    def _derive_i4x4_mode(self, curr, blk, prev_flag, rem) -> int:
        """getIntra4x4PredMode (intra.cpp:77-135)."""
        a_same, a_blk, b_same, b_blk = _luma_blk_neighbors(blk)
        left_edge = curr % self.wmb == 0
        top_edge = curr < self.wmb
        mode_a = mode_b = None
        if a_same:
            mode_a = int(self.i4x4_mode[curr, a_blk])
        elif not left_edge:
            addr = curr - 1
            mode_a = (
                int(self.i4x4_mode[addr, a_blk]) if self.mb_i4x4[addr] else 2
            )
        if b_same:
            mode_b = int(self.i4x4_mode[curr, b_blk])
        elif not top_edge:
            addr = curr - self.wmb
            mode_b = (
                int(self.i4x4_mode[addr, b_blk]) if self.mb_i4x4[addr] else 2
            )
        if mode_a is None or mode_b is None or self.pps.constrained_intra_pred_flag:
            mode_a = mode_b = 2
        pred_mode = min(mode_a, mode_b)
        if prev_flag:
            return pred_mode
        return rem if rem < pred_mode else rem + 1

    def _fetch_p13(self, curr, blk) -> np.ndarray:
        """FetchPredictionSamplesIntra4x4 (intra.cpp:294-378), incl. the
        above-right replication rule."""
        x0, y0 = self._mb_origin(curr)
        bx = int(_BLK_XY[blk, 0])
        by = int(_BLK_XY[blk, 1])
        x, y = x0 + bx, y0 + by
        H, W = self.y.shape
        p = np.full(13, -1, np.int32)
        if x > 0 and y > 0:
            p[0] = self.y[y - 1, x - 1]
        if x > 0:
            p[1:5] = self.y[y : y + 4, x - 1]
        if y > 0:
            p[5:9] = self.y[y - 1, x : x + 4]
            xf = x + 4
            edge = (xf >= W) or (bx == 12 and by > 0)
            if edge or blk in (3, 11):
                p[9:13] = self.y[y - 1, x + 3]
            else:
                p[9:13] = self.y[y - 1, xf : xf + 4]
        return p

    def _fetch_p33(self, curr) -> np.ndarray:
        x0, y0 = self._mb_origin(curr)
        p = np.full(33, -1, np.int32)
        if x0 > 0 and y0 > 0:
            p[0] = self.y[y0 - 1, x0 - 1]
        if x0 > 0:
            p[1:17] = self.y[y0 : y0 + 16, x0 - 1]
        if y0 > 0:
            p[17:33] = self.y[y0 - 1, x0 : x0 + 16]
        return p

    def _fetch_p17(self, curr):
        x0, y0 = self._mb_origin(curr)
        cx, cy = x0 // 2, y0 // 2
        out = []
        for plane in (self.cb, self.cr):
            p = np.full(17, -1, np.int32)
            if cx > 0 and cy > 0:
                p[0] = plane[cy - 1, cx - 1]
            if cx > 0:
                p[1:9] = plane[cy : cy + 8, cx - 1]
            if cy > 0:
                p[9:17] = plane[cy - 1, cx : cx + 8]
            out.append(p)
        return out
