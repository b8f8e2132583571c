// The per-word core of a life-like turn on a bitboard, shared by
// whole_board.cu and tiled.cu: the per-word form of ops/bitpack.py::bit_step.
//
// Bit j of word w along the packed axis is cell 32*w + j. WORD_AXIS 0 packs
// rows (array [H/32, W]), WORD_AXIS 1 packs columns ([H, W/32]). Call the
// position along the packed axis i and the position along the other axis
// (columns for WORD_AXIS 0, rows for WORD_AXIS 1) the line j.
//
// What bounds a turn is the int32 instruction rate: ops/bitpack.py::
// ops_per_word counts 12 instructions per word for Conway. The core spends
// close to that:
// - A thread walks a run of consecutive lines j at one i (gol_walk). It
//   keeps the packed-axis 2-bit sums of the lines j-1 and j in registers, so
//   per output word it loads the three words of line j+1 (i-1, i, i+1), makes
//   one packed sum (2 SHF + 2 LOP3) and finishes with the two full adders,
//   the T planes and the rule's select. Each packed sum is made once per word
//   and each word is loaded three times, not nine.
// - The rule is a template parameter. A StaticRule's masks are constants, so
//   the select folds to the planes it reads (Conway: eq(3) | (mid & eq(4)),
//   no weight-8 plane). The four rules of models/life.py are compiled in
//   (GOL_COMPILED_RULES); any other B/S rule runs the same kernels with a
//   DynamicRule, whose masks are tested at run time.
#pragma once

#include <cstdint>

// The rule as three sets of T values (T = the 3x3 sum INCLUDING the cell,
// 0..9; bit t of a mask = T value t): the next state is alive iff T is in
// `common`, or in `dead_only` for a dead cell, or in `live_only` for a live
// one (ops/bitpack.py::rule_sets builds them from the B/S masks).
template <uint32_t COMMON, uint32_t DEAD_ONLY, uint32_t LIVE_ONLY>
struct StaticRule {
    __host__ __device__ static constexpr uint32_t common() { return COMMON; }
    __host__ __device__ static constexpr uint32_t dead_only() { return DEAD_ONLY; }
    __host__ __device__ static constexpr uint32_t live_only() { return LIVE_ONLY; }
};

struct DynamicRule {
    uint32_t common_mask, dead_only_mask, live_only_mask;
    __host__ __device__ uint32_t common() const { return common_mask; }
    __host__ __device__ uint32_t dead_only() const { return dead_only_mask; }
    __host__ __device__ uint32_t live_only() const { return live_only_mask; }
};

// The rules compiled in, as (common, dead_only, live_only) mask triples.
// ops/bitpack.py::COMPILED_RULES mirrors this list (a test parses it).
#define GOL_COMPILED_RULES(X) \
    X(8u, 0u, 16u)       /* conway, B3/S23 */ \
    X(8u, 64u, 16u)      /* highlife, B36/S23 */ \
    X(0u, 4u, 0u)        /* seeds, B2/S */ \
    X(384u, 72u, 560u)   /* day-and-night, B3678/S34678 */

// Call launch(rule) with the StaticRule of a compiled triple, else with a
// DynamicRule holding the masks; returns what launch returns.
template <class Launch>
int gol_with_rule(unsigned common, unsigned dead_only, unsigned live_only, Launch&& launch) {
#define GOL_RULE_CASE(C, D, L) \
    if (common == C && dead_only == D && live_only == L) return launch(StaticRule<C, D, L>{});
    GOL_COMPILED_RULES(GOL_RULE_CASE)
#undef GOL_RULE_CASE
    return launch(DynamicRule{common, dead_only, live_only});
}

// The 2-bit packed-axis sum of one line at one i: a word and its two
// neighbours along the packed axis, the carries crossing word boundaries
// through the adjacent words (logical shifts, which uint32_t gives).
struct GolLineSum {
    uint32_t v0, v1;  // weights 1 and 2
};

__device__ __forceinline__ void gol_full_adder3(uint32_t a, uint32_t b, uint32_t c,
                                                uint32_t& sum, uint32_t& carry) {
    const uint32_t axb = a ^ b;
    sum = axb ^ c;
    carry = (a & b) | (c & axb);
}

__device__ __forceinline__ GolLineSum gol_line_sum(uint32_t prev, uint32_t mid,
                                                   uint32_t next) {
    const uint32_t minus = (mid << 1) | (prev >> 31);  // cell at packed index - 1
    const uint32_t plus = (mid >> 1) | (next << 31);   // cell at packed index + 1
    GolLineSum s;
    gol_full_adder3(minus, mid, plus, s.v0, s.v1);
    return s;
}

__device__ __forceinline__ uint32_t gol_eq(uint32_t p0, uint32_t p1, uint32_t p2,
                                           uint32_t p3, int value) {
    uint32_t acc = (value & 1) ? p0 : ~p0;
    acc &= (value & 2) ? p1 : ~p1;
    acc &= (value & 4) ? p2 : ~p2;
    // the weight-8 plane only separates T in {8, 9} from {0, 1}
    if (value < 2 || value > 7) acc &= (value & 8) ? p3 : ~p3;
    return acc;
}

__device__ __forceinline__ uint32_t gol_any_eq(uint32_t mask, uint32_t p0, uint32_t p1,
                                               uint32_t p2, uint32_t p3) {
    uint32_t acc = 0;
#pragma unroll
    for (int v = 0; v < 10; ++v) {
        if (mask >> v & 1u) acc |= gol_eq(p0, p1, p2, p3, v);
    }
    return acc;
}

// The output word from the packed sums of lines j-1, j, j+1 and the cell
// word itself: two full adders across the lines give the T planes, then the
// rule's select.
template <class Rule>
__device__ __forceinline__ uint32_t gol_finish(const Rule& rule, GolLineSum a, GolLineSum b,
                                               GolLineSum c, uint32_t mid) {
    uint32_t a_s, a_c, b_s, b_c;
    gol_full_adder3(a.v0, b.v0, c.v0, a_s, a_c);  // weight 1 + weight-2 carry
    gol_full_adder3(a.v1, b.v1, c.v1, b_s, b_c);  // weight 2 + weight-4 carry
    const uint32_t p0 = a_s;
    const uint32_t p1 = a_c ^ b_s;
    const uint32_t c_c = a_c & b_s;
    const uint32_t p2 = b_c ^ c_c;
    const uint32_t p3 = b_c & c_c;  // dead code unless the rule reads it
    return gol_any_eq(rule.common(), p0, p1, p2, p3) |
           (~mid & gol_any_eq(rule.dead_only(), p0, p1, p2, p3)) |
           (mid & gol_any_eq(rule.live_only(), p0, p1, p2, p3));
}

// One run of `len` >= 1 output words at one i, lines j0 .. j0+len-1. `m`,
// `c`, `p` point at the current board's words at packed index i-1, i, i+1
// (wrapped or clamped by the caller) and `out` at the next board's words at
// i; the offsets are line offsets from those pointers: `prev_off` of line
// j0-1, `off` of line j0, `step` from one line to the next, `last_next_off`
// of the line after the last (the torus wrap, where there is one). `m`, `c`
// and `p` may point into the same board: they are only read. The words
// before the last read the next line at a fixed step, so the loop holds no
// select and, where `step` is a constant, its unrolled loads take
// immediate offsets.
template <class Rule>
__device__ __forceinline__ void gol_walk(const uint32_t* __restrict__ m,
                                         const uint32_t* __restrict__ c,
                                         const uint32_t* __restrict__ p,
                                         uint32_t* __restrict__ out,
                                         int prev_off, int off, int step, int len,
                                         int last_next_off, const Rule& rule) {
    GolLineSum a = gol_line_sum(m[prev_off], c[prev_off], p[prev_off]);
    uint32_t mid = c[off];
    GolLineSum b = gol_line_sum(m[off], mid, p[off]);
    const uint32_t* wm = m + off;
    const uint32_t* wc = c + off;
    const uint32_t* wp = p + off;
    uint32_t* wo = out + off;
    for (int s = 1; s < len; ++s) {
        const uint32_t next_mid = wc[step];
        const GolLineSum n = gol_line_sum(wm[step], next_mid, wp[step]);
        *wo = gol_finish(rule, a, b, n, mid);
        a = b;
        b = n;
        mid = next_mid;
        wm += step;
        wc += step;
        wp += step;
        wo += step;
    }
    const GolLineSum n = gol_line_sum(m[last_next_off], c[last_next_off], p[last_next_off]);
    *wo = gol_finish(rule, a, b, n, mid);
}
