"""Device full-search ME vs host reference search."""

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from h264_fer.ops.me import full_search_topk


def test_topk_contains_exhaustive_argmin():
    rng = np.random.default_rng(3)
    H, W, wnd = 64, 80, 8
    src = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = rng.integers(0, 256, (H, W)).astype(np.int32)
    # correlated content so search is meaningful
    ref[8:, 8:] = src[:-8, :-8]

    sads, mvx, mvy = full_search_topk(src, ref, window=wnd, topk=16)
    sads, mvx, mvy = np.asarray(sads), np.asarray(mvx), np.asarray(mvy)

    refp = np.pad(ref, wnd, mode="edge")
    wins = sliding_window_view(refp, (H, W))  # (2w+1, 2w+1, H, W)
    hb, wb = H // 8, W // 8
    for bi in range(hb * wb):
        by, bx = (bi // wb) * 8, (bi % wb) * 8
        sb = src[by : by + 8, bx : bx + 8]
        best = None
        for dy in range(2 * wnd + 1):
            for dx in range(2 * wnd + 1):
                cand = wins[dy, dx][by : by + 8, bx : bx + 8].astype(np.int32)
                sad = int(np.abs(cand - sb).sum())
                if best is None or sad < best[0]:
                    best = (sad, (dx - wnd) * 4, (dy - wnd) * 4)
        # the exhaustive best must appear in the device top-16 with equal SAD
        assert best[0] == sads[bi, 0], (bi, best, sads[bi, :3])
        hits = [
            k for k in range(16)
            if sads[bi, k] == best[0]
        ]
        assert hits, bi


def test_edge_clamp_semantics():
    """Shifts past the frame edge see edge-replicated samples, matching the
    host fetch_window clamping (mocomp.cpp:11-36)."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, (16, 16)).astype(np.int32)
    ref = src.copy()
    sads, mvx, mvy = full_search_topk(src, ref, window=4, topk=4)
    sads = np.asarray(sads)
    # best candidate for a perfect match is SAD 0 at mv (0,0)
    assert sads[0, 0] == 0
    assert int(np.asarray(mvx)[0, 0]) == 0 and int(np.asarray(mvy)[0, 0]) == 0
