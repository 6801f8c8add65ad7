"""16-phase interpolated reference planes (encoder-side).

Vectorized equivalent of the reference's FillInterpolatedRefFrame
(moestimation.cpp:74-173, via FillInterpolSubMBPart mocomp.cpp:80-107):
one plane per fractional position frac = fy*4+fx, each covering an
edge-extended grid so any MV within ±ext full-pel stays in bounds —
the counterpart of the per-window edge clamping (mocomp.cpp:11-36).

Values are bit-identical to mc.interpolate_luma_block for every position
and frac, including the reference's clipped-intermediate chaining for the
center positions (Tap6 over already-Bordered half-pel values).

The math is namespace-generic: `interpolated_planes` (NumPy, host encoder)
and `interpolated_planes_jax` (jnp, for use inside jitted device programs —
pure elementwise/shift work) share one implementation and are
bit-identical.
"""

from __future__ import annotations

import numpy as np


def _tap6_h(p, xp=np):
    """Horizontal 6-tap at (x + 1/2): input padded by >=3 on each side of
    axis 1; output width = in_width - 5."""
    return xp.clip(
        (p[:, 0:-5] - 5 * p[:, 1:-4] + 20 * p[:, 2:-3] + 20 * p[:, 3:-2]
         - 5 * p[:, 4:-1] + p[:, 5:] + 16) >> 5,
        0, 255,
    )


def _tap6_v(p, xp=np):
    return xp.clip(
        (p[0:-5] - 5 * p[1:-4] + 20 * p[2:-3] + 20 * p[3:-2]
         - 5 * p[4:-1] + p[5:] + 16) >> 5,
        0, 255,
    )


def _avg(a, b):
    return (a + b + 1) >> 1


def _planes_impl(ref, ext: int, xp):
    H, W = ref.shape
    # generous pad: ext for MV range + 3 taps each side + 1 for x+1/y+1 avgs
    pad = ext + 4
    P = xp.pad(ref.astype(xp.int32), pad, mode="edge")
    return _planes_from_padded(P, H, W, ext, xp)


def _planes_impl_vext(ref_v, ext: int, xp):
    """Planes for an MB-row BAND whose vertical halo rows are already in
    place: ref_v = (hband + 2*(ext+4), W) with the ext+4 rows above/below
    holding the REAL neighbouring-band pixels (frame edges: replicated
    rows). Pads horizontally only; output planes are bit-identical to
    the corresponding row window of interpolated_planes on the full
    frame — the halo is exactly the `pad` margin _planes_impl builds."""
    pad = ext + 4
    Hv, W = ref_v.shape
    H = Hv - 2 * pad
    P = xp.pad(ref_v.astype(xp.int32), ((0, 0), (pad, pad)), mode="edge")
    return _planes_from_padded(P, H, W, ext, xp)


def _planes_from_padded(P, H, W, ext: int, xp):
    pad = ext + 4
    he, we = H + 2 * ext, W + 2 * ext

    def full(x0, y0, h=he, w=we):
        """View of the integer plane starting at extended-grid offset."""
        return P[pad - ext + y0 : pad - ext + y0 + h,
                 pad - ext + x0 : pad - ext + x0 + w]

    # b: horizontal half-pel at (x+1/2, y) for extended x in [-1, we]
    # need columns x-2..x+3 → slice with margin
    bm = _tap6_h(P[pad - ext : pad - ext + he,
                   pad - ext - 2 : pad - ext + we + 3], xp)  # (he, we)
    # h: vertical half-pel
    hm = _tap6_v(P[pad - ext - 2 : pad - ext + he + 3,
                   pad - ext : pad - ext + we], xp)  # (he, we)
    # m = h at x+1; s = b at y+1 — need shifted variants: recompute with
    # extended ranges instead of slicing beyond edges
    bm_wide = _tap6_h(P[pad - ext - 1 : pad - ext + he + 1,
                        pad - ext - 2 : pad - ext + we + 3], xp)  # rows [-1, he]
    hm_wide = _tap6_v(P[pad - ext - 2 : pad - ext + he + 3,
                        pad - ext - 1 : pad - ext + we + 1], xp)  # cols [-1, we]
    # bm_wide row 0 is y=-1, row 1 is y=0 ... so y+1 = rows 2..
    s = bm_wide[2 : 2 + he, :]
    m = hm_wide[:, 2 : 2 + we]
    # j: horizontal 6-tap over the clipped vertical halves (reference chains
    # Bordered intermediates, mocomp.cpp:66-71)
    hm_j = _tap6_v(P[pad - ext - 2 : pad - ext + he + 3,
                     pad - ext - 2 : pad - ext + we + 3], xp)  # cols [-2, we+2]
    j = _tap6_h(hm_j, xp)[:, : we]
    # hm_j has we+5 columns starting at x=-2; _tap6_h consumes 5 → we columns
    # starting at x=0 ✓

    G = full(0, 0)
    Gx1 = full(1, 0)
    Gy1 = full(0, 1)

    planes = [None] * 16
    planes[0] = G
    planes[1] = _avg(G, bm)
    planes[2] = bm
    planes[3] = _avg(bm, Gx1)
    planes[4] = _avg(G, hm)
    planes[8] = hm
    planes[12] = _avg(hm, Gy1)
    planes[5] = _avg(bm, hm)
    planes[7] = _avg(bm, m)
    planes[13] = _avg(hm, s)
    planes[15] = _avg(s, m)
    planes[10] = j
    planes[6] = _avg(bm, j)
    planes[9] = _avg(hm, j)
    planes[14] = _avg(j, s)
    planes[11] = _avg(j, m)
    return xp.stack(planes)


def interpolated_planes(ref: np.ndarray, ext: int = 0) -> np.ndarray:
    """(16, H + 2*ext, W + 2*ext) int32 planes; plane[frac][ext + y][ext + x]
    is the prediction sample for integer position (x, y) at that frac."""
    return _planes_impl(ref, ext, np)


def interpolated_planes_jax(ref, ext: int = 0):
    """Device variant of interpolated_planes (same bits; call under jit)."""
    import jax.numpy as jnp

    return _planes_impl(ref, ext, jnp)


def interpolated_planes_banded_jax(ref_v, ext: int = 0):
    """Banded device variant: see _planes_impl_vext."""
    import jax.numpy as jnp

    return _planes_impl_vext(ref_v, ext, jnp)


def pad_chroma(ref_c: np.ndarray, ext_c: int) -> np.ndarray:
    """Edge-padded chroma plane for plane-based MC slicing."""
    return np.pad(ref_c.astype(np.int32), ext_c + 1, mode="edge")


def pad_chroma_jax(ref_c, ext_c: int):
    """Device variant of pad_chroma (call under jit)."""
    import jax.numpy as jnp

    return jnp.pad(ref_c.astype(jnp.int32), ext_c + 1, mode="edge")


def mc_macroblock_from_planes(planes, cb_pad, cr_pad, mb_x, mb_y, mv,
                              ext: int, ext_c: int):
    """Whole-MB MC using precomputed planes — bit-identical to
    mc.mc_macroblock (encoder-side fast path).

    planes: interpolated_planes(ref_y, ext); cb_pad/cr_pad: pad_chroma(...,
    ext_c) with ext_c >= ext//2. mv: (4, 4, 2) quadrant-major qpel MVs
    (uniform within each quadrant after DeriveMVs fan-out).
    """
    pred_l = np.empty((16, 16), np.int32)
    pred_cb = np.empty((8, 8), np.int32)
    pred_cr = np.empty((8, 8), np.int32)
    x0, y0 = mb_x * 16, mb_y * 16
    for q in range(4):
        ox, oy = (q & 1) * 8, (q >> 1) * 8
        mvx, mvy = int(mv[q, 0, 0]), int(mv[q, 0, 1])
        frac = (mvy & 3) * 4 + (mvx & 3)
        px = x0 + ox + (mvx >> 2) + ext
        py = y0 + oy + (mvy >> 2) + ext
        pred_l[oy : oy + 8, ox : ox + 8] = planes[frac][py : py + 8, px : px + 8]
        cx = (x0 + ox) // 2 + (mvx >> 3) + ext_c + 1
        cy = (y0 + oy) // 2 + (mvy >> 3) + ext_c + 1
        fx, fy = mvx & 7, mvy & 7
        for cplane, out in ((cb_pad, pred_cb), (cr_pad, pred_cr)):
            if fx == 0 and fy == 0:  # integer chroma MV: plain copy
                out[oy // 2 : oy // 2 + 4, ox // 2 : ox // 2 + 4] = \
                    cplane[cy : cy + 4, cx : cx + 4]
                continue
            a = cplane[cy : cy + 4, cx : cx + 4]
            b = cplane[cy : cy + 4, cx + 1 : cx + 5]
            c = cplane[cy + 1 : cy + 5, cx : cx + 4]
            d = cplane[cy + 1 : cy + 5, cx + 1 : cx + 5]
            out[oy // 2 : oy // 2 + 4, ox // 2 : ox // 2 + 4] = (
                (8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
                + (8 - fx) * fy * c + fx * fy * d + 32
            ) >> 6
    return pred_l, pred_cb, pred_cr


class LazyInterpPlanes:
    """Per-frac lazy variant of interpolated_planes: computes (and caches)
    only the fractional planes actually referenced — decode of mostly
    integer-MV content touches one or two fracs per frame."""

    def __init__(self, ref: np.ndarray, ext: int = 0) -> None:
        H, W = ref.shape
        self._pad = ext + 4
        self._P = np.pad(ref.astype(np.int32), self._pad, mode="edge")
        self._he, self._we = H + 2 * ext, W + 2 * ext
        self._ext = ext
        self._cache: dict[int, np.ndarray] = {}
        self._mid: dict[str, np.ndarray] = {}

    # intermediates -----------------------------------------------------
    def _full(self, x0, y0):
        p0 = self._pad - self._ext
        return self._P[p0 + y0 : p0 + y0 + self._he,
                       p0 + x0 : p0 + x0 + self._we]

    def _get_mid(self, name):
        m = self._mid.get(name)
        if m is not None:
            return m
        p0 = self._pad - self._ext
        P, he, we = self._P, self._he, self._we
        if name == "b":
            m = _tap6_h(P[p0 : p0 + he, p0 - 2 : p0 + we + 3])
        elif name == "h":
            m = _tap6_v(P[p0 - 2 : p0 + he + 3, p0 : p0 + we])
        elif name == "s":  # b at y+1
            bw = _tap6_h(P[p0 - 1 : p0 + he + 1, p0 - 2 : p0 + we + 3])
            m = bw[2 : 2 + he, :]
        elif name == "m":  # h at x+1
            hw = _tap6_v(P[p0 - 2 : p0 + he + 3, p0 - 1 : p0 + we + 1])
            m = hw[:, 2 : 2 + we]
        elif name == "j":
            hj = _tap6_v(P[p0 - 2 : p0 + he + 3, p0 - 2 : p0 + we + 3])
            m = _tap6_h(hj)[:, : we]
        else:
            raise KeyError(name)
        self._mid[name] = m
        return m

    def __getitem__(self, frac: int) -> np.ndarray:
        pl = self._cache.get(frac)
        if pl is not None:
            return pl
        G = self._full(0, 0)
        g = self._get_mid
        if frac == 0:
            pl = G
        elif frac == 1:
            pl = _avg(G, g("b"))
        elif frac == 2:
            pl = g("b")
        elif frac == 3:
            pl = _avg(g("b"), self._full(1, 0))
        elif frac == 4:
            pl = _avg(G, g("h"))
        elif frac == 8:
            pl = g("h")
        elif frac == 12:
            pl = _avg(g("h"), self._full(0, 1))
        elif frac == 5:
            pl = _avg(g("b"), g("h"))
        elif frac == 7:
            pl = _avg(g("b"), g("m"))
        elif frac == 13:
            pl = _avg(g("h"), g("s"))
        elif frac == 15:
            pl = _avg(g("s"), g("m"))
        elif frac == 10:
            pl = g("j")
        elif frac == 6:
            pl = _avg(g("b"), g("j"))
        elif frac == 9:
            pl = _avg(g("h"), g("j"))
        elif frac == 14:
            pl = _avg(g("j"), g("s"))
        elif frac == 11:
            pl = _avg(g("j"), g("m"))
        else:
            raise IndexError(frac)
        self._cache[frac] = pl
        return pl
