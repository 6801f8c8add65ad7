"""P-frame decision wavefront: skip / ME argmin / unify / mb_type / mvd.

The only loop-carried dependency in a P slice is the MV-prediction chain
(mode_pred.cpp:252-426: median predictor over left/top/top-right
neighbours plus earlier quadrants of the same MB). Everything
pixel-heavy was precomputed in bulk (codec/device_pframe.py: integer score
map, two 49-position qpel refinement maps); this wavefront only gathers
scores, adds the λ·|mv − mvp| cost, and arbitrates — plus ONE 16x16
window gather per MB for the P_Skip test (moestimation.cpp:402-425) and
up to four for the 16x16-unify trial (encoder._maybe_unify).

Diagonals run d = c + 2r so left/top/top-right/top-left all land on
earlier diagonals (the top-right dependency needs the factor 2).

Decisions are bit-identical to the host encoder's _inter_encode_mb /
_search_mb / _maybe_unify path driven by the same maps —
tests/test_wavefront_p.py.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

MB_SKIP = -2
# np scalar, NOT jnp: a module-level jax Array gets deduplicated across
# traces by id inside jax-0.9's DynamicJaxprTrace const interning, leaking
# a tracer from the first trace into the second trace's consts — which
# trips pjit's separate_consts path whose C++/AOT dispatch is broken
# ("Execution supplied 7 buffers but compiled program expected 131").
BIG = np.int32(2**31 - 1)

# partition width/height per mb_type 0..4 (h264_globals.h:123-128)
_PW = np.array([16, 16, 8, 8, 8], np.int32)
_PH = np.array([16, 8, 16, 8, 8], np.int32)


def _loc_static(xn: int, yn: int):
    """Static half of DeriveNeighbourLocation (mode_pred.cpp:61-97):
    (dr, dc, xw, yw) or None for never-available."""
    if xn > 15 and yn >= 0:
        return None
    if yn > 15:
        return None
    if 0 <= xn < 16 and yn >= 0:
        return (0, 0, xn, yn)
    if 0 <= xn < 16:  # yn < 0: above
        return (-1, 0, xn, yn + 16)
    if xn > 15:  # above-right
        return (-1, 1, xn - 16, yn + 16)
    if yn < 0 and xn < 0:  # above-left
        return (-1, -1, xn + 16, yn + 16)
    return (0, -1, xn + 16, yn)  # left


def _part_origin(mb_type: int, part: int):
    if mb_type == 1:  # 16x8
        return 0, 8 * part
    if mb_type == 2:  # 8x16
        return 8 * part, 0
    if mb_type in (3, 4):
        return 8 * (part & 1), 8 * (part >> 1)
    return 0, 0


def _pred_part_width(mb_type: int) -> int:
    # sub_mb_type is always P_L0_8x8 in the encoder
    if mb_type == 2 or mb_type in (3, 4):
        return 8
    return 16


class _Ctx:
    """Per-diagonal geometry + state accessors.

    halo: optional (halo_mv (wmb, 4, 2), halo_t (wmb,), has_top bool
    scalar) — the FINAL state of the MB row above the band's first row,
    for MB-row-band tile sharding (local row -1 reads resolve there)."""

    def __init__(self, mvq, mbt, rs, cs, valid, wmb, hmb, halo=None):
        self.mvq, self.mbt = mvq, mbt
        self.rs, self.cs, self.valid = rs, cs, valid
        self.wmb, self.hmb = wmb, hmb
        self.halo = halo

    def fetch(self, loc):
        """Neighbour MV + existence for a static location. Intra never
        occurs in our P slices, so ref is 0 wherever the neighbour exists
        (mode_pred.cpp:48-58)."""
        n = self.rs.shape[0]
        if loc is None:
            return jnp.zeros((n, 2), jnp.int32), jnp.zeros(n, bool)
        dr, dc, xw, yw = loc
        rn = self.rs + dr
        cn = self.cs + dc
        col_ok = self.valid & (cn >= 0) & (cn < self.wmb)
        cn = jnp.clip(cn, 0, self.wmb - 1)
        if self.halo is None or dr == 0:
            exists = col_ok & (rn >= 0)
            rn = jnp.where(exists, rn, self.hmb)  # scratch row
            t = self.mbt[rn, cn]
        else:
            halo_mv, halo_t, has_top = self.halo
            from_halo = rn == -1
            exists = col_ok & ((rn >= 0) | (from_halo & has_top))
            rn = jnp.where(exists & ~from_halo, rn, self.hmb)
            t = jnp.where(from_halo, halo_t[cn], self.mbt[rn, cn])
        ti = jnp.clip(t, 0, 4)
        pw = jnp.asarray(_PW)[ti]
        ph = jnp.asarray(_PH)[ti]
        pidx = ((yw // ph) << 1) + (xw // pw)
        pidx = jnp.where(t == MB_SKIP, 0, pidx)
        mv = self.mvq[rn, cn, pidx]
        if self.halo is not None and dr != 0:
            halo_mv, halo_t, has_top = self.halo
            mv = jnp.where((self.rs + dr == -1)[:, None],
                           halo_mv[cn, pidx], mv)
        return mv, exists


def _predict(ctx: _Ctx, mb_type: int, num_parts: int, part: int):
    """PredictMV_Luma for the encoder's cases (mode_pred.cpp:252-371),
    vectorized over a diagonal. Returns (n, 2) predictor."""
    x, y = _part_origin(mb_type, part)
    pw = _pred_part_width(mb_type)
    mvA, exA = ctx.fetch(_loc_static(x - 1, y))
    mvB, exB = ctx.fetch(_loc_static(x, y - 1))
    mvC, exC = ctx.fetch(_loc_static(x + pw, y - 1))
    mvD, exD = ctx.fetch(_loc_static(x - 1, y - 1))
    # C invalid → D (mode_pred.cpp:297-299)
    mvC = jnp.where(exC[:, None], mvC, mvD)
    exC = exC | exD

    # substitution rules (mode_pred.cpp:318-340): all existing refs are 0
    both_none = ~exA & ~exB
    refA = jnp.where(exA | both_none, 0, -1)
    A = jnp.where(exA[:, None], mvA, 0)
    B = jnp.where(exB[:, None], mvB, A)
    refB = jnp.where(exB, 0, refA)
    C = jnp.where(exC[:, None], mvC, A)
    refC = jnp.where(exC, 0, refA)

    mA, mB, mC = refA == 0, refB == 0, refC == 0
    only_A = mA & ~mB & ~mC
    only_B = ~mA & mB & ~mC
    only_C = ~mA & ~mB & mC
    stack = jnp.stack([A, B, C])  # (3, n, 2)
    med = stack.sum(0) - stack.max(0) - stack.min(0)
    pred = jnp.where(only_A[:, None], A,
                     jnp.where(only_B[:, None], B,
                               jnp.where(only_C[:, None], C, med)))

    # directional special cases (checked FIRST by the host; they return
    # the raw neighbour, so apply them as overrides)
    if mb_type == 1 and part == 0:
        pred = jnp.where(exB[:, None], mvB, pred)
    elif mb_type == 1 and part == 1:
        pred = jnp.where(exA[:, None], mvA, pred)
    elif mb_type == 2 and part == 0:
        pred = jnp.where(exA[:, None], mvA, pred)
    elif mb_type == 2 and part == 1:
        pred = jnp.where(exC[:, None], mvC, pred)
    return pred


def _metric(d, metric_id: int):
    if metric_id == 0:
        return jnp.abs(d)
    d = d * d
    return 2 * d if metric_id == 2 else d


def pframe_decide_impl(src_y, planes, int_map, c1mv, q1map, c2mv, q2map,
                       q2ok, maxdiff, wmb: int, hmb: int, window: int,
                       ext: int, metric_id: int, lam: int, band=None):
    """Run the P-frame decision wavefront.

    src_y: (H, W) int32 source. planes: (16, he, we) interp planes.
    int_map: (nmb, 4, S^2); c1mv/c2mv: (nmb, 4, 2); q1map/q2map:
    (nmb, 4, 49); q2ok: (nmb, 4) bool; maxdiff: (nmb,).

    band: optional (axis_name, n_tile, hmb_total, vary_axes) for MB-row
    band tile sharding — then hmb is the LOCAL row count hloc, the
    knight wavefront runs the GLOBAL hmb_total schedule, the band
    above's last-row MV/type state arrives via a per-wave ppermute halo
    (the MV-prediction analog of the intra recon-row exchange), and the
    band's just-decided bottom-row state leaves the same way.

    Returns dict: skip (nmb,) bool, mb_type (nmb,) int32 (raw, no skip),
    mv (nmb, 4, 2) quadrant-major final MVs, mvd (nmb, 4, 2) per-part
    mvds (unused parts zero), num_parts encoded by mb_type.
    """
    nmb = wmb * hmb
    S = 2 * window + 1
    if band is not None:
        axis, n_tile, hmb_total, vary_axes = band
        t_idx = jax.lax.axis_index(axis)
        row0 = t_idx * hmb
        has_top = t_idx > 0
        perm = [(i, i + 1) for i in range(n_tile - 1)]
    else:
        hmb_total = hmb
        row0 = 0

    src_grid = src_y.reshape(hmb, 16, wmb, 16).transpose(0, 2, 1, 3)

    # integer-candidate qpel MVs, row-major (dy, dx)
    sh = (jnp.arange(S) - window) * 4
    shx = jnp.tile(sh, S)
    shy = jnp.repeat(sh, S)
    # qpel offsets, row-major (dy, dx) — must match qpel_refine_map
    o = jnp.arange(-3, 4)
    offx = jnp.tile(o, 7)
    offy = jnp.repeat(o, 7)

    ndiag = wmb + 2 * hmb_total - 2
    dmax = hmb
    slot = jnp.arange(dmax)

    mvq0 = jnp.zeros((hmb + 1, wmb, 4, 2), jnp.int32)
    mbt0 = jnp.zeros((hmb + 1, wmb), jnp.int32)
    skip0 = jnp.zeros((hmb + 1, wmb), bool)
    mvd0 = jnp.zeros((hmb + 1, wmb, 4, 2), jnp.int32)
    type0 = jnp.zeros((hmb + 1, wmb), jnp.int32)
    hmv0 = jnp.zeros((wmb, 4, 2), jnp.int32)
    ht0 = jnp.zeros((wmb,), jnp.int32)

    def step(d, carry):
        mvq, mbt, skipg, mvdg, typg, hmv, ht = carry
        halo = (hmv, ht, has_top) if band is not None else None
        rs = slot
        cs = d - 2 * (row0 + rs)
        valid = (cs >= 0) & (cs < wmb) & (rs < hmb)
        rc = jnp.where(valid, rs, 0)
        cc = jnp.where(valid, cs, 0)
        rw = jnp.where(valid, rs, hmb)  # scratch row for writes
        mbi = rc * wmb + cc
        ctx = _Ctx(mvq, mbt, rs, cs, valid, wmb, hmb, halo=halo)

        src_mb = src_grid[rc, cc]  # (dmax, 16, 16)
        md = maxdiff[mbi][:, None, None]

        # ---- P_Skip trial (mode_pred.cpp:381-426 + ExactPixels) --------
        edge = (row0 + rs == 0) | (cs == 0)
        top_r = jnp.where(rs > 0, rs - 1, hmb)
        left_c = jnp.clip(cs - 1, 0, wmb - 1)
        zt = (mvq[top_r, cc, 2] == 0).all(axis=-1)
        if band is not None:
            # local row 0's top neighbour lives in the halo row
            zt_h = (hmv[cc, 2] == 0).all(axis=-1)
            zt = jnp.where(rs == 0, zt_h | ~has_top, zt)
        zl = (mvq[rc, left_c, 1] == 0).all(axis=-1)
        pred16 = _predict(ctx, 0, 1, 0)
        skip_mv = jnp.where((edge | zt | zl)[:, None], 0, pred16)

        frac = (skip_mv[:, 1] & 3) * 4 + (skip_mv[:, 0] & 3)
        px = cc * 16 + (skip_mv[:, 0] >> 2) + ext
        py = rc * 16 + (skip_mv[:, 1] >> 2) + ext
        ii = jnp.arange(16)
        spred = planes[frac[:, None, None],
                       py[:, None, None] + ii[None, :, None],
                       px[:, None, None] + ii[None, None, :]]
        is_skip = (jnp.abs(src_mb - spred) <= md).all(axis=(1, 2)) & valid

        # skip state: all quadrants = skip_mv (DeriveMVs fan-out)
        mvq = mvq.at[rw, cc].set(
            jnp.broadcast_to(skip_mv[:, None, :], (dmax, 4, 2)))
        mbt = mbt.at[rw, cc].set(MB_SKIP)

        # ---- per-quadrant search (host _search_mb) ---------------------
        # host sets mb_type=4 before the search so in-MB part_idx reads
        # resolve under the 8x8 partitioning
        mbt = mbt.at[rw, cc].set(jnp.where(is_skip, MB_SKIP, 4))
        qmv = jnp.zeros((dmax, 4, 2), jnp.int32)
        qscore = jnp.zeros((dmax, 4), jnp.int32)
        qmvp = jnp.zeros((dmax, 4, 2), jnp.int32)
        for q in range(4):
            ctx_q = _Ctx(mvq, mbt, rs, cs, valid, wmb, hmb, halo=halo)
            mvp = _predict(ctx_q, 4, 4, q)
            qmvp = qmvp.at[:, q].set(mvp)
            mvpx = mvp[:, 0:1]
            mvpy = mvp[:, 1:2]
            ci = (int_map[mbi, q]
                  + lam * (jnp.abs(shx[None] - mvpx)
                           + jnp.abs(shy[None] - mvpy)))
            c1 = c1mv[mbi, q]
            m1x = c1[:, 0:1] + offx[None]
            m1y = c1[:, 1:2] + offy[None]
            cq1 = (q1map[mbi, q]
                   + lam * (jnp.abs(m1x - mvpx) + jnp.abs(m1y - mvpy)))
            c2 = c2mv[mbi, q]
            m2x = c2[:, 0:1] + offx[None]
            m2y = c2[:, 1:2] + offy[None]
            cq2 = (q2map[mbi, q]
                   + lam * (jnp.abs(m2x - mvpx) + jnp.abs(m2y - mvpy)))
            cq2 = jnp.where(q2ok[mbi, q][:, None], cq2, BIG)
            allc = jnp.concatenate([ci, cq1, cq2], axis=1)
            allx = jnp.concatenate([jnp.broadcast_to(shx[None], ci.shape),
                                    m1x, m2x], axis=1)
            ally = jnp.concatenate([jnp.broadcast_to(shy[None], ci.shape),
                                    m1y, m2y], axis=1)
            k = jnp.argmin(allc, axis=1)
            best = jnp.take_along_axis(allc, k[:, None], 1)[:, 0]
            bx = jnp.take_along_axis(allx, k[:, None], 1)[:, 0]
            by = jnp.take_along_axis(ally, k[:, None], 1)[:, 0]
            qmv = qmv.at[:, q, 0].set(bx)
            qmv = qmv.at[:, q, 1].set(by)
            qscore = qscore.at[:, q].set(best)
            # make this quadrant visible to the next predictor
            mvq = mvq.at[rw, cc, q].set(
                jnp.where(is_skip[:, None], skip_mv, qmv[:, q]))

        # ---- 16x16 unify trial (encoder._maybe_unify) ------------------
        all_eq0 = ((qmv == qmv[:, 0:1]).all(axis=(1, 2)))
        ctx_u = _Ctx(mvq, mbt, rs, cs, valid, wmb, hmb, halo=halo)
        mvp_u = _predict(ctx_u, 0, 1, 0)
        split = qscore.sum(axis=1)
        best_u = jnp.zeros((dmax, 2), jnp.int32)
        best_c = split
        found = jnp.zeros(dmax, bool)
        for j in range(4):
            u = qmv[:, j]
            frac = (u[:, 1] & 3) * 4 + (u[:, 0] & 3)
            pxu = cc * 16 + (u[:, 0] >> 2) + ext
            pyu = rc * 16 + (u[:, 1] >> 2) + ext
            upred = planes[frac[:, None, None],
                           pyu[:, None, None] + ii[None, :, None],
                           pxu[:, None, None] + ii[None, None, :]]
            dist = _metric(upred - src_mb, metric_id).sum(axis=(1, 2))
            cost = (dist + lam * (jnp.abs(u[:, 0] - mvp_u[:, 0])
                                  + jnp.abs(u[:, 1] - mvp_u[:, 1])))
            upd = cost < best_c
            best_c = jnp.where(upd, cost, best_c)
            best_u = jnp.where(upd[:, None], u, best_u)
            found = found | upd
        unify = found & ~all_eq0 & ~is_skip
        qmv = jnp.where(unify[:, None, None],
                        jnp.broadcast_to(best_u[:, None, :], qmv.shape), qmv)

        # ---- mb_type merge (moestimation.cpp:529-551) ------------------
        all_eq = (qmv == qmv[:, 0:1]).all(axis=(1, 2))
        eq_rows = ((qmv[:, 0] == qmv[:, 1]).all(-1)
                   & (qmv[:, 2] == qmv[:, 3]).all(-1))
        eq_cols = ((qmv[:, 0] == qmv[:, 2]).all(-1)
                   & (qmv[:, 1] == qmv[:, 3]).all(-1))
        mb_type = jnp.where(all_eq, 0,
                            jnp.where(eq_rows, 1,
                                      jnp.where(eq_cols, 2, 4)))

        # final per-MB state for later neighbours: quadrant-major MVs and
        # the raw type (host stores via store_part_mvs + fan_out)
        mvq = mvq.at[rw, cc].set(
            jnp.where(is_skip[:, None, None],
                      jnp.broadcast_to(skip_mv[:, None, :], qmv.shape), qmv))
        mbt = mbt.at[rw, cc].set(jnp.where(is_skip, MB_SKIP, mb_type))

        # ---- mvd (host final pass; state now shows the real mb_type) ---
        ctx_f = _Ctx(mvq, mbt, rs, cs, valid, wmb, hmb, halo=halo)
        mvd = jnp.zeros((dmax, 4, 2), jnp.int32)
        # type 0
        p0_t0 = _predict(ctx_f, 0, 1, 0)
        mvd_t0 = qmv[:, 0] - p0_t0
        # type 1 (16x8): parts (q0, q2)
        p0_t1 = _predict(ctx_f, 1, 2, 0)
        p1_t1 = _predict(ctx_f, 1, 2, 1)
        # type 2 (8x16): parts (q0, q1)
        p0_t2 = _predict(ctx_f, 2, 2, 0)
        p1_t2 = _predict(ctx_f, 2, 2, 1)
        # type 4: predictors equal the search-time ones (state identical)
        mvd_t4 = qmv - qmvp
        mvd = jnp.where((mb_type == 0)[:, None, None],
                        mvd.at[:, 0].set(mvd_t0), mvd)
        m1 = jnp.stack([qmv[:, 0] - p0_t1, qmv[:, 2] - p1_t1,
                        jnp.zeros_like(p0_t1), jnp.zeros_like(p0_t1)], 1)
        mvd = jnp.where((mb_type == 1)[:, None, None], m1, mvd)
        m2 = jnp.stack([qmv[:, 0] - p0_t2, qmv[:, 1] - p1_t2,
                        jnp.zeros_like(p0_t2), jnp.zeros_like(p0_t2)], 1)
        mvd = jnp.where((mb_type == 2)[:, None, None], m2, mvd)
        mvd = jnp.where((mb_type == 4)[:, None, None], mvd_t4, mvd)
        mvd = jnp.where(is_skip[:, None, None], 0, mvd)

        skipg = skipg.at[rw, cc].set(is_skip)
        mvdg = mvdg.at[rw, cc].set(mvd)
        typg = typg.at[rw, cc].set(mb_type)

        if band is not None:
            # boundary exchange: this wave's bottom-row final state goes
            # to the next band, becoming its halo for the same column
            # one wave later (margin exactly 1 — the consumer's top-right
            # dependency lands on the previous wave under d = c + 2r)
            bcol = d - 2 * (row0 + hmb - 1)
            bc = jnp.clip(bcol, 0, wmb - 1)
            seg_mv, seg_t = jax.lax.ppermute(
                (mvq[hmb - 1, bc], mbt[hmb - 1, bc]), axis, perm)
            icol = d - 2 * row0 + 2  # sender's column at this wave
            ivalid = (icol >= 0) & (icol < wmb) & has_top
            ic = jnp.clip(icol, 0, wmb - 1)
            hmv = hmv.at[ic].set(jnp.where(ivalid, seg_mv, hmv[ic]))
            ht = ht.at[ic].set(jnp.where(ivalid, seg_t, ht[ic]))
        return mvq, mbt, skipg, mvdg, typg, hmv, ht

    carry0 = (mvq0, mbt0, skip0, mvd0, type0, hmv0, ht0)
    if band is not None:
        # replicated zero init must be marked varying over the manual
        # mesh axes (ppermute/axis_index in the body; scan-vma typing)
        axes = tuple(vary_axes) or (axis,)
        carry0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, axes, to="varying"), carry0)
    mvq, mbt, skipg, mvdg, typg, _, _ = jax.lax.fori_loop(
        0, ndiag, step, carry0)
    return {
        "skip": skipg[:hmb].reshape(nmb),
        "mb_type": typg[:hmb].reshape(nmb),
        "mv": mvq[:hmb].reshape(nmb, 4, 2),
        "mvd": mvdg[:hmb].reshape(nmb, 4, 2),
    }


pframe_decide = functools.partial(jax.jit, static_argnames=(
    "wmb", "hmb", "window", "ext", "metric_id", "lam"))(pframe_decide_impl)
