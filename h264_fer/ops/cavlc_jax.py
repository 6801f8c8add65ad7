"""Batched device-side CAVLC symbol/size computation (norm 9.2).

The device counterpart of the scalar host codec in ops/cavlc.py (reference
residual_block_cavlc_write/_size, residual.cpp:374-957): every quantity is
computed for ALL blocks of a frame at once with vector ops; the only
sequential structure is the norm's own per-coefficient adaptive state
(suffixLength, zerosLeft), unrolled over the static 16-coefficient depth.

Key structural fact exploited by the encoder wavefront: of a block's bits,
ONLY the coeff_token length depends on nC (the neighbor TotalCoeff
context). Everything else — trailing-one signs, level prefix/suffix,
total_zeros, run_before — is a pure function of the level list. So the
expensive part runs embarrassingly parallel over all blocks here, and the
wavefront (which resolves nC and the Intra_4x4-vs-16x16 arbitration)
only gathers precomputed per-context token lengths.

Symbol stream layout (fixed slots per block, for the prefix-scan packer):
  slot 0        coeff_token        (filled by the caller once nC is known)
  slot 1        trailing-one signs (fused: t1 bits)
  slots 2..L+1  level codes        (fused prefix+stop+suffix, ≤28 bits)
  slot L+2      total_zeros
  slots L+3..   run_before         (L-1 slots)
Total 2L+3 slots; empty slots have length 0.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .cavlc_tables import (
    COEFF_TOKEN_BITS,
    COEFF_TOKEN_LEN,
    RUN_BEFORE_BITS,
    RUN_BEFORE_LEN,
    TOTAL_ZEROS_BITS,
    TOTAL_ZEROS_CDC_BITS,
    TOTAL_ZEROS_CDC_LEN,
    TOTAL_ZEROS_LEN,
)


def nc_to_ctx(nc):
    """nC → coeff_token table context (Table 9-5 columns); nc >= 0."""
    return (
        jnp.where(nc < 2, 0, 0)
        + jnp.where(nc >= 2, 1, 0)
        + jnp.where(nc >= 4, 1, 0)
        + jnp.where(nc >= 8, 1, 0)
    )


def ue_bits(v):
    """Bit length of ue(v): 2*floor(log2(v+1)) + 1."""
    # v < 2^31; bit_length via float log2 is unsafe — use integer compare sum
    vv = (v + 1).astype(jnp.uint32)
    nb = jnp.zeros(v.shape, jnp.int32)
    for k in range(1, 32):
        nb = nb + (vv >= jnp.uint32(1 << k)).astype(jnp.int32)
    return 2 * nb + 1


def ue_code(v):
    """(value, length) of ue(v) as one fused symbol: leading zeros, stop
    bit, then the binary remainder — value = v + 1 in `length` bits."""
    return v + 1, ue_bits(v)


def se_bits(v):
    """Bit length of se(v) (signed Exp-Golomb)."""
    u = jnp.where(v > 0, 2 * v - 1, -2 * v)
    return ue_bits(u)


def se_code(v):
    u = jnp.where(v > 0, 2 * v - 1, -2 * v)
    return ue_code(u)


def block_symbols_bulk(levels, max_num_coeff: int, sizes_only: bool = False):
    """Per-block CAVLC symbols and sizes for a batch of blocks.

    levels: (..., L) int32 zig-zag coefficient lists, L = levels.shape[-1].
    max_num_coeff: the maxNumCoeff of this block kind (16/15/4); chroma-DC
    (4) selects the chroma total_zeros table, like the reference's nC == -1.

    Returns dict:
      tc        (...,)   TotalCoeff
      t1        (...,)   TrailingOnes
      rest_bits (...,)   all bits except coeff_token
      ct_len    (..., 5) coeff_token length per nC context
      ct_val    (..., 5) coeff_token codeword per nC context
      vals/lens (..., 2L+3) fused symbol stream (slot 0 zeroed);
                omitted when sizes_only (the mode-decision wavefront only
                needs bit counts — coded_mb_size, rbsp_encoding.cpp:330)
    """
    L = levels.shape[-1]
    chroma_dc = max_num_coeff == 4
    lead = levels.shape[:-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    nz = levels != 0
    nzi = nz.astype(jnp.int32)
    tc = nzi.sum(axis=-1)

    # nonzero values/positions in reverse-scan (high-frequency-first)
    # order. Rank of nonzero i from the top = #nonzeros at positions > i;
    # a one-hot contraction beats a sort.
    rank = tc[..., None] - jnp.cumsum(nzi, axis=-1)  # (..., L)
    onehot = (
        (rank[..., None] == jnp.arange(L)) & nz[..., None]
    ).astype(jnp.int32)  # (..., L, Lrev)
    rev_vals = (levels[..., None] * onehot).sum(axis=-2)
    rev_pos = (pos[:, None] * onehot).sum(axis=-2)
    k_arange = jnp.arange(L, dtype=jnp.int32)
    valid = k_arange < tc[..., None]

    # trailing ones: run of |level| == 1 from the top, capped at 3
    ones = (jnp.abs(rev_vals) == 1) & valid
    t1 = jnp.cumprod(ones[..., :3].astype(jnp.int32), axis=-1).sum(axis=-1)

    # coeff_token per context: one flat row gather (index tc*4+t1 into the
    # (68, 5) table — row gathers of contiguous 5-vectors, no 2D gather)
    ctl = jnp.asarray(np.moveaxis(COEFF_TOKEN_LEN, 0, -1).reshape(-1, 5))
    ctb = jnp.asarray(np.moveaxis(COEFF_TOKEN_BITS, 0, -1).reshape(-1, 5))
    ct_idx = tc * 4 + t1
    ct_len = ctl[ct_idx]  # (..., 5)
    ct_val = ctb[ct_idx]

    # columns are accumulated in Python lists and stacked once at the end
    # (a .at[..., slot].set per step materializes a full copy each time)
    vcols: list = []
    lcols: list = []
    bits_acc = jnp.zeros(lead, jnp.int32)

    # --- trailing one signs (fused into one symbol of t1 bits) ----------
    bits_acc = bits_acc + t1
    if not sizes_only:
        zero = jnp.zeros(lead, jnp.int32)
        vcols.append(zero)  # slot 0: coeff_token (finalize_symbols)
        lcols.append(zero)
        sign = (rev_vals < 0).astype(jnp.int32)
        t1_val = jnp.zeros(lead, jnp.int32)
        for k in range(3):
            in_t1 = k < t1
            # bit k sits at position (t1-1-k) from the LSB
            shift = jnp.maximum(t1 - 1 - k, 0)
            t1_val = t1_val + jnp.where(in_t1, sign[..., k] << shift, 0)
        vcols.append(t1_val)
        lcols.append(t1)

    # --- level codes (adaptive suffixLength fold, unrolled over L) ------
    suffix_len = jnp.where((tc > 10) & (t1 < 3), 1, 0).astype(jnp.int32)
    for i in range(L):
        active = (i >= t1) & (i < tc)
        lv = rev_vals[..., i]
        code = jnp.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        code = code - 2 * ((t1 == i) & (t1 < 3)).astype(jnp.int32)
        sl = suffix_len
        # suffix_len == 0 branch
        p0 = jnp.where(code < 14, code, jnp.where(code < 30, 14, 15))
        s0 = jnp.where(code < 14, 0, jnp.where(code < 30, 4, 12))
        u0 = jnp.where(code < 14, 0,
                       jnp.where(code < 30, code - 14, code - 30))
        # suffix_len > 0 branch
        pr = code >> sl
        px = jnp.minimum(pr, 15)
        sx = jnp.where(pr < 15, sl, 12)
        ux = jnp.where(pr < 15, code & ((1 << sl) - 1), code - (15 << sl))
        prefix = jnp.where(sl == 0, p0, px)
        ssize = jnp.where(sl == 0, s0, sx)
        length = prefix + 1 + ssize
        bits_acc = bits_acc + jnp.where(active, length, 0)
        if not sizes_only:
            suffix = jnp.where(sl == 0, u0, ux)
            value = (1 << ssize) | suffix
            vcols.append(jnp.where(active, value, 0))
            lcols.append(jnp.where(active, length, 0))
        sl1 = jnp.maximum(sl, 1)
        grow = (jnp.abs(lv) > (3 << (sl1 - 1))) & (sl1 < 6)
        sl2 = sl1 + grow.astype(jnp.int32)
        suffix_len = jnp.where(active, sl2, suffix_len)

    # --- total_zeros -----------------------------------------------------
    total_zeros = jnp.where(tc > 0, rev_pos[..., 0] + 1 - tc, 0)
    if chroma_dc:
        tzl = jnp.asarray(TOTAL_ZEROS_CDC_LEN)
        tzb = jnp.asarray(TOTAL_ZEROS_CDC_BITS)
    else:
        tzl = jnp.asarray(TOTAL_ZEROS_LEN)
        tzb = jnp.asarray(TOTAL_ZEROS_BITS)
    tz_active = (tc > 0) & (tc < max_num_coeff)
    tzi = jnp.clip(tc - 1, 0, tzl.shape[0] - 1)
    tzj = jnp.clip(total_zeros, 0, tzl.shape[1] - 1)
    tz_flat = tzi * tzl.shape[1] + tzj  # flat 1D gather
    tz_len = jnp.where(tz_active, tzl.reshape(-1)[tz_flat], 0)
    bits_acc = bits_acc + tz_len
    if not sizes_only:
        vcols.append(jnp.where(tz_active, tzb.reshape(-1)[tz_flat], 0))
        lcols.append(tz_len)

    # --- run_before --------------------------------------------------------
    # zerosLeft before run k has the closed form tz - sum(run_{<k}) =
    # rev_pos[k] + k + 1 - tc, so the whole section vectorizes over k with
    # ONE flat table gather (no sequential fold of 14 dependent stages).
    k_run = jnp.arange(L - 1, dtype=jnp.int32)
    zeros_left = rev_pos[..., : L - 1] + k_run + 1 - tc[..., None]
    active = (k_run <= tc[..., None] - 2) & (zeros_left > 0)
    run = rev_pos[..., : L - 1] - rev_pos[..., 1:] - 1
    run = jnp.where(active, run, 0)
    esc = zeros_left > 6
    v_esc = jnp.where(run < 7, 7 - run, 1)
    l_esc = jnp.where(run < 7, 3, run - 3)
    zi = jnp.clip(zeros_left - 1, 0, 5)
    ri = jnp.clip(run, 0, 6)
    rb_flat = zi * RUN_BEFORE_LEN.shape[1] + ri
    length = jnp.where(esc, l_esc,
                       jnp.asarray(RUN_BEFORE_LEN).reshape(-1)[rb_flat])
    length = jnp.where(active, length, 0)
    bits_acc = bits_acc + length.sum(axis=-1)
    if not sizes_only:
        value = jnp.where(esc, v_esc,
                          jnp.asarray(RUN_BEFORE_BITS).reshape(-1)[rb_flat])
        value = jnp.where(active, value, 0)
        vcols.extend(jnp.moveaxis(value, -1, 0))
        lcols.extend(jnp.moveaxis(length, -1, 0))

    out = {
        "tc": tc,
        "t1": t1,
        "rest_bits": bits_acc,
        "ct_len": ct_len,
        "ct_val": ct_val,
    }
    if not sizes_only:
        out["vals"] = jnp.stack(vcols, axis=-1)
        out["lens"] = jnp.stack(lcols, axis=-1)
    return out


def finalize_symbols(blk, ctx):
    """Fill slot 0 with the coeff_token for the resolved nC contexts.

    blk: output of block_symbols_bulk; ctx: (...,) int32 in 0..4.
    Returns (vals, lens) with all slots final. The 5-way context select
    is a dense compare-sum, not a take_along_axis — a per-element gather
    serializes whatever fusion it lands in.
    """
    sel = (ctx[..., None] == jnp.arange(5)).astype(jnp.int32)
    ct_val = (blk["ct_val"] * sel).sum(axis=-1)
    ct_len = (blk["ct_len"] * sel).sum(axis=-1)
    vals = blk["vals"].at[..., 0].set(ct_val)
    lens = blk["lens"].at[..., 0].set(ct_len)
    return vals, lens


# ---------------------------------------------------------------------------
# Hierarchical dense bit packing: (value, length) symbol streams → words.


def _factor(c: int) -> tuple[int, int]:
    """(a, b) with a*b >= c, both near sqrt(c) (one-hot GEMM factors)."""
    import math
    b = max(1, int(math.isqrt(c)))
    a = -(-c // b)
    return a, b


def pack_symbols(vals, lens, nw: int | None = None, cap: int | None = None,
                 preset=None):
    """Pack a flat symbol stream into a uint32 big-endian word array.

    vals/lens: (n,) int32, each value in `length` bits (MSB-first, len
    <= 32), zero lengths skipped. Returns (words uint32 (nw,),
    total_bits, ok) — ok is False when some symbol group overflowed the
    `cap` capacity tier (the payload is then incomplete; retry with a
    larger tier; total_bits is exact regardless).

    cap: average-bits capacity tier in words per 64 symbols (8 covers
    4 bit/symbol averages — typical CAVLC residual at medium QP; 24
    covers dense low-QP frames). None = worst case (a symbol is at most
    one word), which can never overflow: ok is always True.

    A 1080p frame has ~7M symbols, so per-symbol indexed placement
    (gather/scatter/searchsorted per element) is avoided. This pack is
    hierarchical and DENSE end to end:

    1. groups of `group` symbols → (cap+1)-word windows by masked column
       sums (`cap` is a capacity tier — `cap=group` never overflows
       since a symbol is at most one word);
    2. `chunk_groups` group windows → one chunk window by a factorized
       one-hot GEMM: window word index w = a*B + b becomes two one-hot
       factors and the placement is einsum('cia,cib->cab') (a matrix product),
       exact in f32 because the disjoint-bit contributions are summed as
       16-bit halves (< 2^24). `slices` splits this einsum into a
       lax.map over chunk slices to bound the one-hot materialization;
    3. chunk windows splice into the output with a short
       dynamic_update_slice scan (~2 us/step, one step per chunk).

    nw: static output capacity in words. Bits past 32*nw are silently
    dropped — callers must check total_bits <= 32*nw and retry at a
    larger capacity (the default is the worst case, which never drops).
    """
    n = vals.shape[0]
    if nw is None:
        nw = (n * 28) // 32 + 3
    # preset (group size, cap, chunk size, einsum slicing) per capacity
    # tier; slices bound the one-hot materialization at 1080p scale
    if preset is not None:
        group, cap, chunk_groups, slices = preset
    elif cap is None:
        group, cap, chunk_groups, slices = 16, 16, 256, 16
    elif cap <= 8:
        group, cap, chunk_groups, slices = 64, cap, 256, 2
    else:
        group, cap, chunk_groups, slices = 64, cap, 256, 8
    lens = lens.astype(jnp.int32)
    g = group
    syms_chunk = g * chunk_groups
    pad = (-n) % (syms_chunk * slices)
    if pad:
        vals = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])
        lens = jnp.concatenate([lens, jnp.zeros((pad,), jnp.int32)])
    lens2 = lens.reshape(-1, g)
    v = vals.reshape(-1, g).astype(jnp.uint32)

    # --- level 1: per-group windows (dense masked sums) -----------------
    csum = jnp.cumsum(lens2, axis=-1)
    off = csum - lens2  # local bit offset of each symbol within the group
    gbits = csum[:, -1]  # (ngrp,)
    ok = jnp.all(gbits <= 32 * cap)
    w = off >> 5
    bit = off & 31
    # value occupies bits [bit, bit+len) from word w's MSB; split into a
    # hi part for word w and a lo spill into word w+1
    sh_hi = 32 - bit - lens2  # may be negative
    hi = jnp.where(
        sh_hi >= 0,
        v << jnp.maximum(sh_hi, 0).astype(jnp.uint32),
        v >> jnp.minimum(-sh_hi, 31).astype(jnp.uint32),
    ).astype(jnp.uint32)
    lo_sh = ((64 - bit - lens2) & 31).astype(jnp.uint32)
    lo = jnp.where(sh_hi < 0, v << lo_sh, jnp.uint32(0)).astype(jnp.uint32)
    active = lens2 > 0
    hi = jnp.where(active, hi, 0)
    lo = jnp.where(active, lo, 0)
    # window column j collects hi parts of symbols in local word j and lo
    # spills of symbols in local word j-1 (disjoint bits: sum == or)
    w1 = cap + 1
    win = jnp.stack([
        jnp.where(w == j, hi, 0).sum(-1, dtype=jnp.uint32)
        + (jnp.where(w == j - 1, lo, 0).sum(-1, dtype=jnp.uint32)
           if j else 0)
        for j in range(w1)
    ], axis=-1)  # (ngrp, w1)

    # --- level 2: GEMM-place group windows into chunk windows -----------
    ngrp = lens2.shape[0]
    nchunk = ngrp // chunk_groups
    gb_c = gbits.reshape(nchunk, chunk_groups)
    gcs = jnp.cumsum(gb_c, axis=-1)
    cbits = gcs[:, -1]  # (nchunk,) bits per chunk
    gloc = gcs - gb_c   # group bit offset within its chunk
    # chunk window capacity: worst case for in-tier groups, plus spill
    c1 = chunk_groups * cap + w1 + 1
    a1, b1 = _factor(c1)
    r = (gloc & 31).astype(jnp.uint32)
    rs = (jnp.uint32(32) - r) & 31
    base_w = (gloc >> 5)  # (nchunk, chunk_groups)
    winc = win.reshape(nchunk, chunk_groups, w1)

    def place(carry, xs):
        winc, base_w, r, rs = xs
        # funnel-shift each group window right by r bits → w1+1 columns
        shifted = jnp.concatenate([
            (winc >> r[..., None])
            | jnp.where(
                (r > 0)[..., None],
                jnp.pad(winc[..., :-1], ((0, 0), (0, 0), (1, 0)))
                << rs[..., None],
                0),
            jnp.where((r > 0)[..., None],
                      winc[..., -1:] << rs[..., None], 0),
        ], axis=-1)  # (nc, cg, w1+1)
        pos = base_w[..., None] + jnp.arange(w1 + 1)  # word index in chunk
        pa = pos // b1
        pb = pos - pa * b1
        nc = shifted.shape[0]
        items = shifted.reshape(nc, -1)
        pa = pa.reshape(nc, -1)
        pb = pb.reshape(nc, -1)
        aoh = (pa[..., None] == jnp.arange(a1)).astype(jnp.float32)
        boh = (pb[..., None] == jnp.arange(b1)).astype(jnp.float32)
        out = []
        for shift in (0, 16):
            half = ((items >> shift) & 0xFFFF).astype(jnp.float32)
            # HIGHEST precision: the default matmul precision runs bf16
            # passes that round 16-bit halves (e.g. 0x4567 -> 0x4580) and
            # silently corrupt the payload; highest is exact for < 2^24
            cell = jnp.einsum("cia,cib->cab", aoh * half[..., None], boh,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
            out.append(cell.astype(jnp.uint32))
        cw = (out[1] << 16) | out[0]
        return carry, cw.reshape(nc, a1 * b1)[:, :c1]

    if slices > 1:
        sl = lambda x: x.reshape((slices, nchunk // slices) + x.shape[1:])
        _, cwin = jax.lax.scan(
            place, 0, (sl(winc), sl(base_w), sl(r), sl(rs)))
        cwin = cwin.reshape(nchunk, c1)
    else:
        _, cwin = place(0, (winc, base_w, r, rs))

    # --- level 3: splice chunk windows into the output ------------------
    ccs = jnp.cumsum(cbits)
    total = ccs[-1] if n else jnp.int32(0)
    cloc = ccs - cbits
    cr = (cloc & 31).astype(jnp.uint32)
    crs = (jnp.uint32(32) - cr) & 31
    cw_sh = jnp.concatenate([
        (cwin >> cr[:, None])
        | jnp.where((cr > 0)[:, None],
                    jnp.pad(cwin[:, :-1], ((0, 0), (1, 0))) << crs[:, None],
                    0),
        jnp.where((cr > 0)[:, None], cwin[:, -1:] << crs[:, None], 0),
    ], axis=-1)  # (nchunk, c1+1)
    cword = cloc >> 5

    # derive the zero carry from the data so its varying manual axes
    # match the scanned xs under shard_map (scan-vma typing rule)
    outbuf = jnp.zeros((nw + c1 + 2,), jnp.uint32) + (cw_sh[0, 0] & 0)

    def splice(buf, xs):
        row, start = xs
        seg = jax.lax.dynamic_slice(buf, (start,), (c1 + 1,))
        return jax.lax.dynamic_update_slice(buf, seg | row, (start,)), None

    outbuf, _ = jax.lax.scan(
        splice, outbuf, (cw_sh, jnp.minimum(cword, nw)))
    return outbuf[:nw], total, ok


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: big-endian words → byte string of ceil(total_bits/8)."""
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words, ">u4").tobytes()[:nbytes]
