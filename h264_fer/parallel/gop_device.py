"""GOP-axis data parallelism: end-to-end multi-device all-intra encode.

The codec counterpart of data parallelism (SURVEY.md §2.4): IDR frames are
independent, so a batch of frames shards across the ``gop`` mesh axis and
every device runs the full single-frame device program
(codec/device_iframe.py: mode decision → wavefront reconstruction →
whole-slice CAVLC packing) on its shard — zero collectives, pure DP. The
host reads back each frame's packed payload (content-sized) and stitches
the ordered Annex-B stream: SPS/PPS once, then one IDR NAL per frame with
the exact slice-header state sequence of the serial encoder
(idr_pic_id = frame index since frame_num stays 0 — encoder.py
_encode_slice), so the result is byte-identical to
``Encoder(device_iframe=...).encode_sequence``.

The reference has no multi-device anything; its closest analog is the
frame-at-a-time loop in encode() (fer_h264.cpp:81-134). This module is
the BASELINE.json config-5 path: GOP sharding with host-side ordered
bitstream concatenation.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bitstream import nal as nal_mod
from ..bitstream.bitio import BitWriter
from ..bitstream.params import I_SLICE, P_SLICE, PPS, SPS, SliceHeader
from ..ops import transform
from ..ops.cavlc_jax import words_to_bytes


def _tiers(nmb: int):
    """(words, cap) payload tiers, smallest first: 768 bit/MB, then ×8,
    then unbounded (the serial encoder's tiers, codec/encoder.py)."""
    return ((nmb * 24, 8), (nmb * 192, 24), (None, None))


def _zero_frame(w: int, h: int):
    """Black (y, cb, cr) uint8 planes: stand-in content for compile()."""
    return (np.zeros((h, w), np.uint8), np.zeros((h // 2, w // 2), np.uint8),
            np.zeros((h // 2, w // 2), np.uint8))


class GopIntraEncoder:
    """All-intra sequence encoder sharded over a 1-D ``gop`` device mesh.

    mode: "i16" (I16-only device frames) or "mixed" (exact I4x4-vs-I16
    bit-cost arbitration) — the same two flavors as Encoder.device_iframe.
    """

    def __init__(self, width: int, height: int, qp: int,
                 mode: str = "i16", devices=None,
                 deblock: bool = False) -> None:
        assert width % 16 == 0 and height % 16 == 0
        from ..codec.device_iframe import (
            device_i16_frame,
            device_i16_frame_impl,
            device_mixed_frame,
            device_mixed_frame_impl,
        )

        self.w, self.h, self.qp = width, height, qp
        self.wmb, self.hmb = width // 16, height // 16
        self.nmb = self.wmb * self.hmb
        self.qpc = transform.chroma_qp(qp, 0)
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.deblock = bool(deblock)
        self.pps = PPS(pic_init_qp=14 + qp,
                       deblocking_filter_control_present_flag=1 if deblock
                       else 0)
        self.devices = list(devices) if devices is not None else jax.devices()
        self.mesh = Mesh(np.asarray(self.devices), ("gop",))
        # jitted entry for direct single-device dispatch; unjitted impl
        # for embedding under vmap+jit (nested-jit bug, codec/device_intra.py)
        self._frame_fn = (device_mixed_frame if mode == "mixed"
                          else device_i16_frame)
        self._frame_impl = (device_mixed_frame_impl if mode == "mixed"
                            else device_i16_frame_impl)
        self._cache = {}

    def _frame_kw(self, nw, cap) -> dict:
        return dict(wmb=self.wmb, hmb=self.hmb, qp=self.qp, qpc=self.qpc,
                    nw=nw, cap=cap, deblock=self.deblock)

    def _upload(self, f):
        """One frame's planes onto the single device."""
        return tuple(jax.device_put(np.asarray(p, np.uint8), self.devices[0])
                     for p in f)

    def _stack(self, frames):
        """(B, ...) uint8 plane stacks, padded to a multiple of the device
        count by repeating the last frame (padded frames are discarded)."""
        pad = (-len(frames)) % len(self.devices)
        return tuple(np.stack([f[k] for f in frames]
                              + [frames[-1][k]] * pad).astype(np.uint8)
                     for k in range(3))

    def _batched(self, nw, cap):
        key = (nw, cap)
        if key not in self._cache:
            core = functools.partial(self._frame_impl,
                                     **self._frame_kw(nw, cap))
            sh = NamedSharding(self.mesh, P("gop"))

            def run(y, cb, cr):
                out = jax.vmap(core)(y, cb, cr)
                return out["words"], out["nbits"], out["pack_ok"]

            self._cache[key] = jax.jit(
                run, in_shardings=(sh, sh, sh), out_shardings=(sh, sh, sh))
        return self._cache[key]

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def compile(self, n_frames: int):
        """Compile the program encode_sequence runs first for n_frames
        frames (its first payload tier, with the same placement) and
        return it as a ``jax.stages.Compiled``; its memory_analysis()
        sizes the program. The jit cache keeps it, so the encode that
        follows does not compile it again."""
        zero = _zero_frame(self.w, self.h)
        nw, cap = _tiers(self.nmb)[0]
        if len(self.devices) == 1:
            return self._frame_fn.lower(
                *self._upload(zero), **self._frame_kw(nw, cap)).compile()
        return self._batched(nw, cap).lower(
            *self._stack([zero] * n_frames)).compile()

    def _device_payloads(self, frames):
        """Run the sharded batch; returns (words (B, nw) np, nbits (B,))."""
        n_dev = len(self.devices)
        b = len(frames)
        if n_dev == 1:
            # single device: the per-frame program as-is (no vmap batch
            # dim — the serial path's per-frame program).
            # PIPELINED: IDR frames are independent, so every frame's
            # program is dispatched before any readback and the uploads,
            # compute and downloads of successive frames overlap (the
            # async-overlap design of IntraCL,
            # openCL_functions.cpp:221-274, one level up).
            tiers = _tiers(self.nmb)

            def dispatch(f, nw, cap):
                out = self._frame_fn(*f, **self._frame_kw(nw, cap))
                # retain only the payload outputs: holding the full dict
                # would pin every frame's recon planes in device memory
                # until the readback loop reaches it (O(frames) HBM)
                return {"words": out["words"], "meta": out["meta"]}

            nw0, cap0 = tiers[0]
            # upload and dispatch alternate, so one frame's transfer can
            # overlap the previous frame's compute
            outs = []
            dframes = []
            for f in frames:
                df = self._upload(f)
                outs.append(dispatch(df, nw0, cap0))
                dframes.append(df)
            frames = dframes
            # one stacked meta readback instead of one per frame
            metas = np.array(jnp.stack([o["meta"] for o in outs]))
            esc = {}
            for i, f in enumerate(frames):
                nb, pok = int(metas[i, 0]), int(metas[i, 1])
                if nb > 32 * nw0 or not pok:  # rare: escalate this frame
                    for nw, cap in tiers[1:]:
                        out = dispatch(f, nw, cap)
                        nb, pok = (int(v) for v in np.asarray(out["meta"]))
                        if (nw is None or nb <= 32 * nw) and pok:
                            break
                    esc[i] = (out, nb)
                    metas[i, 0] = nb
            nbits = metas[:, 0].astype(np.int64)
            # bucketed readback (see encoder._device_iframe_encode_full):
            # one COMMON power-of-two bucket and one stacked fetch
            nwords = (int(nbits.max()) + 31) // 32
            step = max(1024, (1 << max(nwords - 1, 1).bit_length()) // 8)
            bucket = min(-(-nwords // step) * step, outs[0]["words"].shape[0])
            wstack = np.asarray(jnp.stack(
                [o["words"][:bucket] for o in outs]))
            words = list(wstack)
            for i, (out, nb) in esc.items():
                words[i] = np.asarray(out["words"])
            return words, nbits
        ys, cbs, crs = self._stack(frames)
        # tiered payload capacity like the serial path (encoder.py):
        # escalate when any frame overflows its static word budget
        for nw, cap in _tiers(self.nmb):
            words, nbits, pok = self._batched(nw, cap)(ys, cbs, crs)
            nbits_h = np.asarray(nbits)
            if ((nw is None or int(nbits_h.max()) <= 32 * nw)
                    and bool(np.asarray(pok).all())):
                break
        return np.asarray(words)[:b], nbits_h[:b]

    def encode_sequence(self, frames, idr_base: int = 0) -> bytes:
        """frames: list of (y, cb, cr) uint8 planes. Returns the full
        Annex-B stream, byte-identical to the serial device-path encoder.

        idr_base: global index of frames[0] in a multi-host split
        (parallel/dist.py) — idr_pic_id runs globally across spans."""
        words, nbits = self._device_payloads(frames)
        out = bytearray(self.headers())
        for i in range(len(frames)):
            out += self._stitch_nal(words[i], int(nbits[i]),
                                    idr_pic_id=idr_base + i)
        return bytes(out)

    def _stitch_nal(self, frame_words: np.ndarray, nbits: int,
                    idr_pic_id: int) -> bytes:
        shd = SliceHeader(
            slice_type=I_SLICE,
            frame_num=0,
            idr_pic_id=idr_pic_id,
            pic_order_cnt_lsb=0,
            slice_qp_delta=-14,
            disable_deblocking_filter_idc=0 if self.deblock else 1,
        )
        w = BitWriter()
        shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
        w.append_bits(words_to_bytes(frame_words, nbits), nbits)
        w.rbsp_trailing_bits()
        return nal_mod.write_nal_unit(1, nal_mod.NAL_IDR, w.getvalue())


def _grow(a: np.ndarray, n: int) -> np.ndarray:
    """Zero-extend the last axis of a to length n (escalated-GOP merge)."""
    if a.shape[-1] >= n:
        return a
    pad = [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])]
    return np.pad(a, pad)


class GopIpppEncoder:
    """IPPP sequence encoder sharded over a 1-D ``gop`` device mesh.

    The sequence splits into IDR-delimited GOPs of ``gop_len`` frames;
    each GOP is one fully-device program (codec/device_gop.device_gop_ippp:
    device I-frame, then a lax.scan P-frame chain carrying the DPB and MV
    state), and GOPs batch across devices — temporal data parallelism
    with zero collectives. Streams are byte-identical to the serial
    ``Encoder(device_iframe=True, device_pframe=True, intra_every=gop_len)``
    ONLY under that encoder's matching config: ``deblock=False`` (the
    emitted headers hardcode disable_deblocking_filter_idc=1) and a
    matching IDR rule — fixed GOPs need ``scene_cut_idr=False``;
    ``scene_cut_source=True`` here matches the serial encoder's
    ``scene_cut_idr=True, scene_cut_source=True`` mode (adaptive IDRs
    from SOURCE-frame SAD, ref_frames.cpp:185-234's decision made
    precomputable so variable-length GOPs still shard).
    """

    def __init__(self, width: int, height: int, qp: int, gop_len: int,
                 window_size: int = 16, maxdiff: int = -1,
                 lossy_prefilter: bool = True, devices=None,
                 scene_cut_source: bool = False) -> None:
        assert width % 16 == 0 and height % 16 == 0
        assert gop_len >= 2, "use GopIntraEncoder for all-intra"
        self.scene_cut_source = bool(scene_cut_source)
        self.w, self.h, self.qp, self.T = width, height, qp, gop_len
        self.wmb, self.hmb = width // 16, height // 16
        self.nmb = self.wmb * self.hmb
        self.qpc = transform.chroma_qp(qp, 0)
        self.window = window_size // 2
        self.maxdiff = maxdiff
        self.prefilter = bool(lossy_prefilter and qp < 36)
        self.sps = SPS(pic_width_in_mbs=self.wmb,
                       pic_height_in_map_units=self.hmb)
        self.pps = PPS(pic_init_qp=14 + qp)
        self.devices = list(devices) if devices is not None else jax.devices()
        self.mesh = Mesh(np.asarray(self.devices), ("gop",))
        self._set_hdrs(gop_len)
        self._cache = {}

    def _set_hdrs(self, T: int) -> None:
        """P slice headers for GOP length T: frame_num/POC sequences are
        deterministic, so the header bytes (and the bit counts the device
        scan needs for the trailing-skip drop) are precomputed."""
        self._p_hdrs = []
        for j in range(1, T):
            shd = SliceHeader(
                slice_type=P_SLICE, frame_num=j & (self.sps.max_frame_num - 1),
                idr_pic_id=0,
                pic_order_cnt_lsb=(2 * j) & (
                    (1 << self.sps.log2_max_pic_order_cnt_lsb) - 1),
                slice_qp_delta=-14, disable_deblocking_filter_idc=1)
            w = BitWriter()
            shd.write(w, self.sps, self.pps, nal_mod.NAL_NOT_IDR, 1)
            bits = w.bit_position
            if w.bit_position % 8:  # zero-pad for storage; append_bits
                w.write(0, 8 - w.bit_position % 8)  # replays `bits` only
            self._p_hdrs.append((w.getvalue(), bits))
        self._hdr_bits = np.asarray([b for _, b in self._p_hdrs], np.int32)

    def headers(self) -> bytes:
        w = BitWriter()
        self.sps.write(w)
        w.rbsp_trailing_bits()
        out = nal_mod.write_nal_unit(1, nal_mod.NAL_SPS, w.getvalue())
        w = BitWriter()
        self.pps.write(w)
        w.rbsp_trailing_bits()
        return out + nal_mod.write_nal_unit(1, nal_mod.NAL_PPS, w.getvalue())

    def _gop_kw(self, nw, cap) -> dict:
        return dict(wmb=self.wmb, hmb=self.hmb, window=self.window,
                    qp=self.qp, qpc=self.qpc, cfg_maxdiff=self.maxdiff,
                    prefilter=self.prefilter, nw_i=nw, cap_i=cap, nw_p=nw,
                    cap_p=cap)

    def _gop_fn(self, nw, cap, impl: bool = False):
        from ..codec.device_gop import device_gop_ippp, device_gop_ippp_impl

        # impl=True: unjitted body for embedding under vmap+jit
        # (nested-jit bug, see codec/device_intra.py)
        return functools.partial(
            device_gop_ippp_impl if impl else device_gop_ippp,
            **self._gop_kw(nw, cap))

    def _upload(self, *planes):
        """One GOP's (T, ...) plane stacks onto the single device."""
        return tuple(jax.device_put(np.asarray(p, np.uint8), self.devices[0])
                     for p in planes)

    def _put_sharded(self, gops):
        """(G, T, ...) plane stacks split over the gop mesh axis."""
        sh = NamedSharding(self.mesh, P("gop"))
        return tuple(jax.device_put(np.asarray(a), sh) for a in gops)

    def _batched(self, nw, cap):
        key = (nw, cap)
        if key not in self._cache:
            core = self._gop_fn(nw, cap, impl=True)
            sh = NamedSharding(self.mesh, P("gop"))

            def run(ys, cbs, crs, hdr_bits):
                out = jax.vmap(core, in_axes=(0, 0, 0, None))(
                    ys, cbs, crs, hdr_bits)
                return (out["words_i"], out["meta_i"],
                        out["words_p"], out["meta_p"])

            self._cache[key] = jax.jit(
                run, in_shardings=(sh, sh, sh, None),
                out_shardings=(sh, sh, sh, sh))
        return self._cache[key]

    def _meta_ok(self, meta_i, meta_p, nw) -> bool:
        ms = np.concatenate(
            [np.asarray(meta_i)[..., None, :2].reshape(-1, 2),
             np.asarray(meta_p)[..., :2].reshape(-1, 2)])
        size_ok = True if nw is None else bool((ms[:, 0] <= 32 * nw).all())
        return size_ok and bool((ms[:, 1] > 0).all())

    def _device_payloads(self, gops):
        """gops: (G, T, ...) plane stacks. Returns host (words_i, meta_i,
        words_p, meta_p) with the gop padding removed by the caller."""
        n_dev = len(self.devices)
        tiers = _tiers(self.nmb)
        ys, cbs, crs = gops
        if n_dev == 1:
            # pipelined: every GOP's program is dispatched before any
            # readback, alternating with the uploads like GopIntraEncoder
            hdr_bits = jax.device_put(self._hdr_bits, self.devices[0])
            nw0, cap0 = tiers[0]
            fn = self._gop_fn(nw0, cap0)
            # retain only payload outputs: the full dict would pin every
            # GOP's recon planes in device memory until readback
            keep = ("words_i", "meta_i", "words_p", "meta_p")
            dgops = []
            outs = []
            for g in range(len(ys)):
                y, cb, cr = self._upload(ys[g], cbs[g], crs[g])
                dgops.append((y, cb, cr))
                o = fn(y, cb, cr, hdr_bits)
                outs.append({k: o[k] for k in keep})
            # stacked meta readbacks (2 for the whole sequence), then one
            # common-bucket stacked words fetch instead of per-GOP
            # full-width words_p readbacks
            mi = np.array(jnp.stack([o["meta_i"] for o in outs]))
            mp = np.array(jnp.stack([o["meta_p"] for o in outs]))
            esc = {}
            for g in range(len(ys)):
                if not self._meta_ok(mi[g], mp[g], nw0):
                    for nw, cap in tiers[1:]:  # rare: escalate this GOP
                        out = self._gop_fn(nw, cap)(
                            dgops[g][0], dgops[g][1], dgops[g][2], hdr_bits)
                        if self._meta_ok(out["meta_i"], out["meta_p"], nw):
                            break
                    esc[g] = {k: np.asarray(out[k]) for k in keep}
                    mi[g] = esc[g]["meta_i"]
                    mp[g] = esc[g]["meta_p"]
            nb_max = max(int(mi[:, 0].max()), int(mp[:, :, 0].max()))
            nwords = (nb_max + 31) // 32
            step = max(1024, (1 << max(nwords - 1, 1).bit_length()) // 8)
            bucket = min(-(-nwords // step) * step,
                         outs[0]["words_i"].shape[0])
            wi = np.asarray(jnp.stack(
                [o["words_i"][:bucket] for o in outs]))
            wp = np.asarray(jnp.stack(
                [o["words_p"][:, :bucket] for o in outs]))
            if esc:
                full = max([wi.shape[-1]]
                           + [e["words_i"].shape[0] for e in esc.values()]
                           + [e["words_p"].shape[1] for e in esc.values()])
                wi = _grow(wi, full)
                wp = _grow(wp, full)
                for g, e in esc.items():
                    wi[g, : e["words_i"].shape[0]] = e["words_i"]
                    wp[g, :, : e["words_p"].shape[1]] = e["words_p"]
            return wi, mi, wp, mp
        ysj, cbsj, crsj = self._put_sharded(gops)
        for nw, cap in tiers:
            wi, mi, wp, mp = self._batched(nw, cap)(
                ysj, cbsj, crsj, self._hdr_bits)
            if self._meta_ok(mi, mp, nw):
                break
        return (np.asarray(wi), np.asarray(mi),
                np.asarray(wp), np.asarray(mp))

    def _gop_lengths(self, frames) -> list:
        """Per-GOP frame counts. Fixed mode: gop_len-sized chunks.
        scene_cut_source: an extra IDR wherever the source-SAD threshold
        fires (the serial encoder's scene_cut_source rule — thresholds
        and the absolute-frame-count IntraEvery period both match
        encoder._select_nal_unit_type)."""
        b = len(frames)
        if not self.scene_cut_source:
            return [min(self.T, b - s) for s in range(0, b, self.T)]
        thr = self.nmb << 12
        lens = []
        cur = 0
        for i in range(1, b):
            cut = (i % self.T == 0) or (
                int(np.abs(frames[i][0].astype(np.int64)
                           - frames[i - 1][0].astype(np.int64)).sum()) > thr)
            if cut:
                lens.append(i - cur)
                cur = i
        lens.append(b - cur)
        return lens

    def _gop_stacks(self, frames):
        """(GOP lengths, (ys, cbs, crs)): frames split into GOPs, each
        padded to the longest by repeating its last frame, and the GOP
        count padded to a multiple of the device count."""
        lens = self._gop_lengths(frames)
        T = max(max(lens), 2)
        if T != len(self._p_hdrs) + 1:
            self._set_hdrs(T)
        n_gop = len(lens)
        gpad = 0 if len(self.devices) == 1 else (-n_gop) % len(self.devices)
        starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
        gops = [[frames[s + min(j, L - 1)] for j in range(T)]
                for s, L in zip(starts, lens)]  # per-GOP pad: repeat last
        ys = np.stack([[f[0] for f in g] for g in gops])
        cbs = np.stack([[f[1] for f in g] for g in gops])
        crs = np.stack([[f[2] for f in g] for g in gops])
        if gpad:
            rep = lambda a: np.concatenate(  # noqa: E731
                [a, np.repeat(a[-1:], gpad, axis=0)])
            ys, cbs, crs = rep(ys), rep(cbs), rep(crs)
        return lens, (ys, cbs, crs)

    def compile(self, n_frames: int):
        """Compile the program encode_sequence runs first for n_frames
        frames (its first payload tier, with the same placement) and
        return it as a ``jax.stages.Compiled``; its memory_analysis()
        sizes the program. The jit cache keeps it, so the encode that
        follows does not compile it again."""
        zero = _zero_frame(self.w, self.h)
        _, gops = self._gop_stacks([zero] * n_frames)
        nw, cap = _tiers(self.nmb)[0]
        if len(self.devices) == 1:
            from ..codec.device_gop import device_gop_ippp

            hdr_bits = jax.device_put(self._hdr_bits, self.devices[0])
            return device_gop_ippp.lower(
                *self._upload(*(a[0] for a in gops)), hdr_bits,
                **self._gop_kw(nw, cap)).compile()
        return self._batched(nw, cap).lower(
            *self._put_sharded(gops), self._hdr_bits).compile()

    def encode_sequence(self, frames) -> bytes:
        """frames: list of (y, cb, cr) uint8 planes; length need not be a
        multiple of gop_len or the device count (padded GOPs/frames are
        encoded and discarded)."""
        lens, gops = self._gop_stacks(frames)
        n_gop = len(lens)
        wi, mi, wp, mp = self._device_payloads(gops)
        out = bytearray(self.headers())
        idr_id = 0
        prev_was_idr = False
        for g in range(n_gop):
            for j in range(int(lens[g])):
                if j == 0:
                    # idr_pic_id sequence (encoder._encode_slice): 0 on
                    # the first IDR and after P frames; +1 when the
                    # previous frame was also an IDR (length-1 GOPs)
                    if g == 0:
                        idr_id = 0
                    elif prev_was_idr:
                        idr_id += 1
                    else:
                        idr_id = 0
                    shd = SliceHeader(
                        slice_type=I_SLICE, frame_num=0, idr_pic_id=idr_id,
                        pic_order_cnt_lsb=0, slice_qp_delta=-14,
                        disable_deblocking_filter_idc=1)
                    w = BitWriter()
                    shd.write(w, self.sps, self.pps, nal_mod.NAL_IDR, 1)
                    nbits = int(mi[g][0])
                    w.append_bits(words_to_bytes(wi[g], nbits), nbits)
                    w.rbsp_trailing_bits()
                    out += nal_mod.write_nal_unit(
                        1, nal_mod.NAL_IDR, w.getvalue())
                    prev_was_idr = True
                else:
                    hdr_bytes, hdr_bits = self._p_hdrs[j - 1]
                    w = BitWriter()
                    w.append_bits(hdr_bytes, hdr_bits)
                    nbits = int(mp[g, j - 1, 0])
                    w.append_bits(words_to_bytes(wp[g, j - 1], nbits), nbits)
                    w.rbsp_trailing_bits()
                    out += nal_mod.write_nal_unit(
                        1, nal_mod.NAL_NOT_IDR, w.getvalue())
                    prev_was_idr = False
        return bytes(out)
