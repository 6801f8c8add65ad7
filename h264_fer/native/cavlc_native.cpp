// Native host-runtime component: CAVLC residual symbol generation, MSB-first
// bit packing, and Annex-B emulation prevention.
//
// The native counterpart of the reference's entropy/bit plumbing
// (residual.cpp residual_block_cavlc_write, rbsp_IO.cpp writeRawBits,
// nal.cpp writeNAL): the device computes levels in bulk; this code turns
// them into bits on the host at native speed. Semantics are identical to
// ops/cavlc.py / bitstream/bitio.py / bitstream/nal.py (tests compare).
//
// Built with plain g++ into a shared object, loaded via ctypes (no
// pybind11 in this image).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// MSB-first bit packing. Returns total bit count. `out` must hold
// ceil(sum(lens)/8) bytes; bits beyond the count are zero.
long bitpack(const uint32_t* vals, const uint8_t* lens, long n, uint8_t* out) {
    uint64_t acc = 0;
    int nacc = 0;
    long nbytes = 0;
    long bits = 0;
    for (long i = 0; i < n; i++) {
        int nb = lens[i];
        acc = (acc << nb) | (vals[i] & ((nb >= 32) ? 0xFFFFFFFFu : ((1u << nb) - 1)));
        nacc += nb;
        bits += nb;
        while (nacc >= 8) {
            nacc -= 8;
            out[nbytes++] = (uint8_t)(acc >> nacc);
        }
        acc &= (nacc >= 64) ? ~0ull : ((1ull << nacc) - 1);
    }
    if (nacc > 0) {
        out[nbytes++] = (uint8_t)(acc << (8 - nacc));
    }
    return bits;
}

// ---------------------------------------------------------------------------
// Emulation prevention insertion (nal.cpp:272-295). Returns output length.
long insert_epb(const uint8_t* in, long n, uint8_t* out) {
    long pos = 0;
    int zeros = 0;
    for (long i = 0; i < n; i++) {
        uint8_t b = in[i];
        if (zeros >= 2 && b <= 3) {
            out[pos++] = 3;
            zeros = 0;
        }
        out[pos++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    return pos;
}

// ---------------------------------------------------------------------------
// CAVLC residual block symbol generation (ops/cavlc.py block_symbols).
// Tables are passed in flat (see python wrapper for layouts).
// Returns the number of symbols written; *total_coeff_out gets TotalCoeff.

static inline void level_code_parts(int level_code, int suffix_len,
                                    int* prefix, int* ssize, int* suffix) {
    if (suffix_len == 0) {
        if (level_code < 14) { *prefix = level_code; *ssize = 0; *suffix = 0; return; }
        if (level_code < 30) { *prefix = 14; *ssize = 4; *suffix = level_code - 14; return; }
        *prefix = 15; *ssize = 12; *suffix = level_code - 30; return;
    }
    int p = level_code >> suffix_len;
    if (p < 15) { *prefix = p; *ssize = suffix_len; *suffix = level_code & ((1 << suffix_len) - 1); return; }
    *prefix = 15; *ssize = 12; *suffix = level_code - (15 << suffix_len);
}

int cavlc_block_symbols(
    const int32_t* levels, int max_num_coeff, int nc,
    const int32_t* ct_len, const int32_t* ct_bits,     // [5*17*4]
    const int32_t* tz_len, const int32_t* tz_bits,     // [15*16]
    const int32_t* tzc_len, const int32_t* tzc_bits,   // [3*4]
    const int32_t* rb_len, const int32_t* rb_bits,     // [6*7]
    uint32_t* out_vals, uint8_t* out_lens, int* total_coeff_out) {
    int nonzero_pos[16];
    int total_coeff = 0;
    for (int i = 0; i < max_num_coeff; i++) {
        if (levels[i] != 0) nonzero_pos[total_coeff++] = i;
    }
    int trailing_ones = 0;
    for (int i = total_coeff - 1; i >= 0; i--) {
        int v = levels[nonzero_pos[i]];
        if ((v == 1 || v == -1) && trailing_ones < 3) trailing_ones++;
        else break;
    }
    int ctx;
    if (nc == -1) ctx = 4;
    else if (nc < 2) ctx = 0;
    else if (nc < 4) ctx = 1;
    else if (nc < 8) ctx = 2;
    else ctx = 3;

    int ns = 0;
    int idx = (ctx * 17 + total_coeff) * 4 + trailing_ones;
    out_vals[ns] = (uint32_t)ct_bits[idx];
    out_lens[ns++] = (uint8_t)ct_len[idx];
    *total_coeff_out = total_coeff;
    if (total_coeff == 0) return ns;

    for (int i = 0; i < trailing_ones; i++) {
        int lv = levels[nonzero_pos[total_coeff - 1 - i]];
        out_vals[ns] = lv < 0 ? 1 : 0;
        out_lens[ns++] = 1;
    }
    int suffix_len = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
    for (int i = trailing_ones; i < total_coeff; i++) {
        int lv = levels[nonzero_pos[total_coeff - 1 - i]];
        int code = lv > 0 ? 2 * lv - 2 : -2 * lv - 1;
        if (i == trailing_ones && trailing_ones < 3) code -= 2;
        int prefix, ssize, suffix;
        level_code_parts(code, suffix_len, &prefix, &ssize, &suffix);
        out_vals[ns] = 1;                       // prefix zeros + stop bit
        out_lens[ns++] = (uint8_t)(prefix + 1);
        if (ssize > 0) {
            out_vals[ns] = (uint32_t)suffix;
            out_lens[ns++] = (uint8_t)ssize;
        }
        if (suffix_len == 0) suffix_len = 1;
        int abslv = lv < 0 ? -lv : lv;
        if (abslv > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int total_zeros = nonzero_pos[total_coeff - 1] + 1 - total_coeff;
    if (total_coeff < max_num_coeff) {
        if (nc != -1) {
            int tzi = (total_coeff - 1) * 16 + total_zeros;
            out_vals[ns] = (uint32_t)tz_bits[tzi];
            out_lens[ns++] = (uint8_t)tz_len[tzi];
        } else {
            int tzi = (total_coeff - 1) * 4 + total_zeros;
            out_vals[ns] = (uint32_t)tzc_bits[tzi];
            out_lens[ns++] = (uint8_t)tzc_len[tzi];
        }
    }

    int zeros_left = total_zeros;
    for (int i = total_coeff - 1; i > 0; i--) {
        if (zeros_left <= 0) break;
        int run_before = nonzero_pos[i] - nonzero_pos[i - 1] - 1;
        if (zeros_left > 6) {
            if (run_before < 7) {
                out_vals[ns] = (uint32_t)(7 - run_before);
                out_lens[ns++] = 3;
            } else {
                out_vals[ns] = 1;               // zeros then stop bit
                out_lens[ns++] = (uint8_t)(run_before - 4 + 1);
            }
        } else {
            int rbi = (zeros_left - 1) * 7 + run_before;
            out_vals[ns] = (uint32_t)rb_bits[rbi];
            out_lens[ns++] = (uint8_t)rb_len[rbi];
        }
        zeros_left -= run_before;
    }
    return ns;
}

// ---------------------------------------------------------------------------
// Frame-granularity slice entropy for the all-device I16 path: the device
// computes every level array for the frame (wavefront reconstruction);
// this emits the complete macroblock_layer bit sequence for the whole
// slice in one call (the native counterpart of the reference's per-MB
// rbsp_encoding.cpp:175-305 loop for an all-Intra_16x16 I slice).
// Semantics identical to codec/encoder.py _intra_encode_mb_device (tests
// compare byte-for-byte).

struct BitSink {
    uint8_t* out;
    uint64_t acc = 0;
    int nacc = 0;
    long nbytes = 0;
    long bits = 0;
    inline void put(uint32_t v, int nb) {
        acc = (acc << nb) | (v & ((nb >= 32) ? 0xFFFFFFFFu : ((1u << nb) - 1)));
        nacc += nb;
        bits += nb;
        while (nacc >= 8) {
            nacc -= 8;
            out[nbytes++] = (uint8_t)(acc >> nacc);
        }
        acc &= (nacc >= 64) ? ~0ull : ((1ull << nacc) - 1);
    }
    inline void put_ue(uint32_t v) {  // Exp-Golomb: (nb-1) zeros + nb bits of v+1
        v += 1;
        int nb = 32 - __builtin_clz(v);
        put(v, 2 * nb - 1);
    }
    inline void flush_partial() {  // left-align any tail bits (caller tracks `bits`)
        if (nacc > 0) out[nbytes++] = (uint8_t)(acc << (8 - nacc));
    }
};

long i16_frame_entropy(
    const int32_t* mode16, const int32_t* cmode,   // [nmb]
    const int32_t* i16dc,                          // [nmb*16]
    const int32_t* i16ac,                          // [nmb*16*15]
    const int32_t* cdc,                            // [2*nmb*4]
    const int32_t* cac,                            // [2*nmb*4*15]
    int nmb, int wmb,
    const int32_t* luma_nbr,                       // [16*4] a_same,a_blk,b_same,b_blk
    const int32_t* chroma_nbr,                     // [4*4]
    const int32_t* ct_len, const int32_t* ct_bits,
    const int32_t* tz_len, const int32_t* tz_bits,
    const int32_t* tzc_len, const int32_t* tzc_bits,
    const int32_t* rb_len, const int32_t* rb_bits,
    uint8_t* out,
    int32_t* mb_type_out,                          // [nmb]
    int32_t* cbp_luma_out, int32_t* cbp_chroma_out,  // [nmb]
    int32_t* tc_luma_out,                          // [nmb*16], zeroed by caller
    int32_t* tc_chroma_out) {                      // [2*nmb*4], zeroed by caller
    BitSink w{out};
    uint32_t vals[80];
    uint8_t lens[80];

    for (int mb = 0; mb < nmb; mb++) {
        // setCodedBlockPattern (rbsp_encoding.cpp:21-105), I16 variant
        const int32_t* ac = i16ac + (long)mb * 16 * 15;
        int cbp_l = 0;
        for (int i8 = 0; i8 < 4; i8++) {
            const int32_t* p = ac + i8 * 4 * 15;
            for (int j = 0; j < 4 * 15; j++)
                if (p[j]) { cbp_l = 15; break; }
            if (cbp_l) break;
        }
        int cbp_c = 0;
        for (int c = 0; c < 2 && !cbp_c; c++)
            for (int k = 0; k < 4; k++)
                if (cdc[((long)c * nmb + mb) * 4 + k]) { cbp_c = 1; break; }
        for (int c = 0; c < 2 && cbp_c != 2; c++)
            for (int j = 0; j < 4 * 15; j++)
                if (cac[(((long)c * nmb + mb) * 4) * 15 + j]) { cbp_c = 2; break; }
        cbp_luma_out[mb] = cbp_l;
        cbp_chroma_out[mb] = cbp_c;
        // I-slice mb_type for Intra_16x16 (Table 7-11)
        int mb_type = 1 + mode16[mb] + 4 * cbp_c + (cbp_l == 15 ? 12 : 0);
        mb_type_out[mb] = mb_type;
        w.put_ue((uint32_t)mb_type);
        w.put_ue((uint32_t)cmode[mb]);
        w.put(1, 1);  // mb_qp_delta = se(0)

        bool left_edge = (mb % wmb) == 0;
        bool top_edge = mb < wmb;
        // nC with CBP gating (residual.cpp:87-106; all MBs here are coded I16)
        auto nc_luma = [&](int blk) -> int {
            const int32_t* nbr = luma_nbr + blk * 4;
            int nA = -1, nB = -1;
            if (nbr[0]) {
                nA = (cbp_luma_out[mb] & (1 << (nbr[1] >> 2)))
                         ? tc_luma_out[(long)mb * 16 + nbr[1]] : 0;
            } else if (!left_edge) {
                nA = (cbp_luma_out[mb - 1] & (1 << (nbr[1] >> 2)))
                         ? tc_luma_out[(long)(mb - 1) * 16 + nbr[1]] : 0;
            }
            if (nbr[2]) {
                nB = (cbp_luma_out[mb] & (1 << (nbr[3] >> 2)))
                         ? tc_luma_out[(long)mb * 16 + nbr[3]] : 0;
            } else if (!top_edge) {
                nB = (cbp_luma_out[mb - wmb] & (1 << (nbr[3] >> 2)))
                         ? tc_luma_out[(long)(mb - wmb) * 16 + nbr[3]] : 0;
            }
            if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
            if (nA >= 0) return nA;
            if (nB >= 0) return nB;
            return 0;
        };
        auto nc_chroma = [&](int c, int blk) -> int {
            const int32_t* nbr = chroma_nbr + blk * 4;
            int nA = -1, nB = -1;
            if (nbr[0]) {
                nA = (cbp_chroma_out[mb] & 2)
                         ? tc_chroma_out[((long)c * nmb + mb) * 4 + nbr[1]] : 0;
            } else if (!left_edge) {
                nA = (cbp_chroma_out[mb - 1] & 2)
                         ? tc_chroma_out[((long)c * nmb + mb - 1) * 4 + nbr[1]] : 0;
            }
            if (nbr[2]) {
                nB = (cbp_chroma_out[mb] & 2)
                         ? tc_chroma_out[((long)c * nmb + mb) * 4 + nbr[3]] : 0;
            } else if (!top_edge) {
                nB = (cbp_chroma_out[mb - wmb] & 2)
                         ? tc_chroma_out[((long)c * nmb + mb - wmb) * 4 + nbr[3]] : 0;
            }
            if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
            if (nA >= 0) return nA;
            if (nB >= 0) return nB;
            return 0;
        };
        auto emit = [&](const int32_t* levels, int maxc, int nc) -> int {
            int tc = 0;
            int ns = cavlc_block_symbols(levels, maxc, nc, ct_len, ct_bits,
                                         tz_len, tz_bits, tzc_len, tzc_bits,
                                         rb_len, rb_bits, vals, lens, &tc);
            for (int i = 0; i < ns; i++) w.put(vals[i], lens[i]);
            return tc;
        };

        // residual order: Intra16x16DC, 16 AC (CBP-gated), chroma DC, chroma AC
        tc_luma_out[(long)mb * 16 + 0] = emit(i16dc + (long)mb * 16, 16, nc_luma(0));
        if (cbp_l) {
            for (int blk = 0; blk < 16; blk++) {
                tc_luma_out[(long)mb * 16 + blk] =
                    emit(ac + (long)blk * 15, 15, nc_luma(blk));
            }
        }
        if (cbp_c & 3) {
            for (int c = 0; c < 2; c++)
                emit(cdc + ((long)c * nmb + mb) * 4, 4, -1);
        }
        if (cbp_c & 2) {
            for (int c = 0; c < 2; c++)
                for (int blk = 0; blk < 4; blk++)
                    tc_chroma_out[((long)c * nmb + mb) * 4 + blk] =
                        emit(cac + (((long)c * nmb + mb) * 4 + blk) * 15, 15,
                             nc_chroma(c, blk));
        }
    }
    w.flush_partial();
    return w.bits;
}

}  // extern "C"
