// Deep-overlap linearizability event walk for Hopper (sm_90a).
//
// Replaces the Pallas kernel of jepsen_tpu/ops/wgl_deep.py::_build (the
// pallas_call at :358) together with its compact-wire unpack prologue
// _build_c (:449).  It computes, for every history of a batch, what that
// kernel computes for one: (alive, first_dead_row) of the just-in-time
// linearization walk over the register-delta event rows.
//
// State.  The frontier is a bit plane fr[SnP][NW] of 32-bit words: state
// row s, mask word w (NW = max(1, 2^R / 32)); bit i of word w is the set
// of linearized open calls (w * 32 + i).  The TPU kernel stacks P
// sub-planes of 512 words past R = 14; here the plane is one flat array
// of 2^R / 32 words per row, so the word-split depths R = 15/16 are
// ordinary word bits.  Slot b < 5 moves bits inside a word; slot b >= 5
// moves words from column w (bit b - 5 clear) to column w | (1 << (b-5)).
//
// The walk (kept exactly from the TPU kernel, so the plane-word count
// `work` is the same on both arms and equals the plain version's): per
// row, the lazy-retirement merge of each new invoke's slot; at a return
// of slot rs the fast-path test, then Gauss-Seidel closure rounds (one
// pass per open slot, ascending) to a fixpoint or lack == 0, the prune,
// and the first dead row.  A batch is a grid and nothing carries between
// CTAs.  Each history's open-slot table (a1, a2, t0 of slot b) lives in
// lane b of every warp and is read with a shuffle broadcast.
//
// Two arms, chosen per history by ops/deep_kernel.arm_of at the boundary
// WARP_MAX_R (below; PERF.md records the card's times behind it):
//
// Warp arm (depth <= 10, one warp per CTA, one history per warp).  The
// plane is at most 32 columns by 32 rows, so it sits in registers:
// lane l owns column l % NW and the rows s with s % (32/NW) == l / NW,
// at most 32 words.  What bounds it on this card is the latency of a
// row's chain of dependent passes, not bytes: a plane this small keeps
// few threads busy, so a design with shared-memory loads and a barrier
// in every pass waits on them all.  Here a pass is a few dozen register
// instructions: intra-word slots shift the lane's own words; column
// slots exchange words with __shfl_xor_sync(., d) and only the lane
// whose column has the bit ORs them in; the OR over state rows is a
// loop over the lane's rows and an xor-shuffle over the lanes sharing
// the column; every count is one __reduce_add_sync; the next open
// slot's words are broadcast while a pass runs.  No barrier and no shared plane.  The arm is templated on
// (LNW, SnP) and fully unrolled, so no register array is indexed at run
// time; a switch over the depth picks the instantiation, so one grid
// walks histories of mixed depths.
//
// Block arm (depth 11..16, one CTA per history).  Thread t owns the word
// columns t, t + T, ... (T threads), so warp q owns 32 consecutive
// columns: slots b < 10 move words only inside a warp, and b >= 10
// crosses warps.  What bounds it is the plane's bytes per pass through
// one SM (PERF.md's bound, in shared-memory bandwidth).  Where the plane
// lives depends on the shape (deep_kernel.block_plane):
//   registers (R <= 14, and R = 15 at SnP <= 16): thread t holds column
//     t's SnP words, so only the cross-warp passes touch shared memory;
//     at 1024 threads a thread may use 64 registers, which 16 plane
//     words leave room in and 32 do not;
//   shared memory (R = 15 at SnP = 32, R = 16 at SnP <= 16), one column
//     per thread: every warp access is 32 consecutive words, so no pass
//     has a bank conflict;
//   global memory at R = 16, SnP = 32 (256 KB), with the same code.
// Passes: b < 5 on the thread's own words, no synchronisation; 5 <= b
// < 10 by shuffles (register plane) or, on the memory plane, by two
// lanes per column pair of the warp, each moving half of the state rows
// from the bit-clear column into the bit-set one, between two
// __syncwarp (so no lane idles, as the bit-set owners would); b >= 10
// after one __syncthreads (none where both columns are one thread's,
// b = 15 at T = 1024).  So a closure round with every slot open costs
// (R - 10) + 1 barriers, not one per slot: the +1 is the round's block
// sum, which takes one barrier through double-buffered warp partials;
// on the memory plane the count is taken in the round's last pass.
//
// Races.  A thread reads or writes another warp's column only after a
// barrier that follows the column's last write, and before the barrier
// that precedes its next one.  Register plane: cross-warp words go
// through one of two exchange buffers, written before the barrier and
// read after it; the buffers alternate, so a buffer is written again
// only after the next barrier, which every reader of its last use has
// passed.  Memory plane: a cross-warp pass has the owner of each column
// with the slot bit set pull the bit-clear column, which nobody writes in
// that pass; a cross-warp merge ORs the partner column in between two
// barriers and clears its own half after the second.  Within a warp,
// shuffles need no barrier, and the memory plane's in-warp passes, the
// only writes to a column by another thread than its owner, are
// ordered by the __syncwarp before and after them.
#include <cstdint>
#include <cuda_runtime.h>

#define FULL 0xFFFFFFFFu

// Invoke columns per event row of the wire (the reference's I; I = 2
// carries every depth, R = 1 with its second column empty).
constexpr int I = 2;
constexpr int EB = 512;         // block arm: rows staged per step
constexpr int WEB = 256;        // warp arm: rows staged per step
constexpr int WARP_MAX_R = 10;  // deepest history the warp arm walks

// Intra-word "lacks bit b" patterns: bit i set iff mask index i has bit
// b clear.
__constant__ uint32_t c_intra[5] = {0x55555555u, 0x33333333u,
                                    0x0F0F0F0Fu, 0x00FF00FFu,
                                    0x0000FFFFu};

__device__ __forceinline__ uint32_t lackpat(int b, int w) {
    if (b < 5) return c_intra[b];
    return ((w >> (b - 5)) & 1) ? 0u : FULL;
}

__device__ __forceinline__ uint32_t bcast(uint32_t v, int lane) {
    return __shfl_sync(FULL, v, lane);
}

// One open slot's transition words (diagonal a1, constant a2 to state
// t0), broadcast from lane b, which holds slot b's.
struct Slot {
    uint32_t a1, a2;
    int t0;
};

__device__ __forceinline__ Slot slot_of(uint32_t sa1, uint32_t sa2,
                                        uint32_t st0, int b) {
    return {bcast(sa1, b), bcast(sa2, b), (int)bcast(st0, b)};
}

// One history's compact wire: ret + 1 u8[L2] ++ islot + 1 u8[L2 * I] ++
// iuop u16-LE[L2 * I].
struct Wire {
    const uint8_t *ret, *isl, *iu;
    int L2;
};

__device__ __forceinline__ Wire wire_of(const uint8_t *cbuf,
                                        const int64_t *offs,
                                        const int32_t *nrows, int h) {
    Wire w;
    w.L2 = nrows[h];
    w.ret = cbuf + offs[h];
    w.isl = w.ret + w.L2;
    w.iu = w.ret + (size_t)w.L2 * (1 + I);
    return w;
}

// Staged event rows: the return slot, and each invoke's slot with its
// (a1, a2, t0) gathered from the aux table.
struct Stage {
    int32_t *ret, *isl, *t0;
    uint32_t *a1, *a2;
};

__device__ __forceinline__ Stage stage_at(uint32_t *base, int rows) {
    Stage s;
    s.ret = reinterpret_cast<int32_t *>(base);
    s.isl = s.ret + rows;
    s.a1 = reinterpret_cast<uint32_t *>(s.isl + rows * I);
    s.a2 = s.a1 + rows * I;
    s.t0 = reinterpret_cast<int32_t *>(s.a2 + rows * I);
    return s;
}

__device__ __forceinline__ void stage_rows(const Wire &wr, const Stage &st,
                                           const uint32_t *aux, int UP,
                                           int g0, int nb, int tid,
                                           int nt) {
    for (int r = tid; r < nb; r += nt) st.ret[r] = (int)wr.ret[g0 + r] - 1;
    for (int k = tid; k < nb * I; k += nt) {
        const size_t e = (size_t)g0 * I + k;
        const int sl = (int)wr.isl[e] - 1;
        st.isl[k] = sl;
        if (sl >= 0) {
            const int u = (int)wr.iu[2 * e] | ((int)wr.iu[2 * e + 1] << 8);
            st.a1[k] = aux[u];
            st.a2[k] = aux[UP + u];
            st.t0[k] = (int)aux[2 * UP + u];
        }
    }
}

// ---------------------------------------------------------------------------
// Warp arm: one warp, the plane in registers
// ---------------------------------------------------------------------------

template <int LNW, int SnP>
__device__ __forceinline__ void warp_walk(const Wire wr, const Stage st,
                                          const uint32_t *aux, int UP,
                                          int &dead_out,
                                          long long &words_out) {
    constexpr int NW = 1 << LNW;
    constexpr int LPC = 32 / NW;                  // lanes per column
    constexpr int RPL = (SnP * NW + 31) / 32;     // rows per lane
    constexpr int PW = SnP * NW;
    const int lane = threadIdx.x & 31;
    const int col = lane & (NW - 1);
    const int rg = lane >> LNW;
    // row of the lane's k-th word is rg + k * LPC (< 32); where the plane
    // has fewer than 32 words, the lanes past it hold rows >= SnP, which
    // stay zero: no transition targets them
    uint32_t x[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) x[k] = (lane == 0 && k == 0) ? 1u : 0u;
    uint32_t sa1 = 0u, sa2 = 0u, st0 = 0u, openm = 0u;
    int dead = -1;
    long long words = 0;
    for (int g0 = 0; g0 < wr.L2 && dead < 0; g0 += WEB) {
        const int nb = min(WEB, wr.L2 - g0);
        stage_rows(wr, st, aux, UP, g0, nb, lane, 32);
        __syncwarp();
        for (int r = 0; r < nb && dead < 0; ++r) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = st.isl[r * I + i];
                if (sl < 0) continue;
                if (lane == sl) {
                    sa1 = st.a1[r * I + i];
                    sa2 = st.a2[r * I + i];
                    st0 = (uint32_t)st.t0[r * I + i];
                }
                openm |= 1u << sl;
                // lazy-retirement merge of the slot bit onto 0
                if (sl < 5) {
                    const uint32_t lp = c_intra[sl];
                    const int sh = 1 << sl;
#pragma unroll
                    for (int k = 0; k < RPL; ++k)
                        x[k] = (x[k] & lp) | ((x[k] & ~lp) >> sh);
                } else {
                    const int d = 1 << (sl - 5);
                    const bool set = col & d;
#pragma unroll
                    for (int k = 0; k < RPL; ++k) {
                        const uint32_t y = __shfl_xor_sync(FULL, x[k], d);
                        x[k] = set ? 0u : (x[k] | y);
                    }
                }
                words += 2 * PW;
            }
            const int rs = st.ret[r];
            if (rs < 0) continue;

            const uint32_t lrs = lackpat(rs, col);
            const uint32_t a1t = bcast(sa1, rs), a2t = bcast(sa2, rs);
            int n_lt = 0, n_ill = 0;
#pragma unroll
            for (int k = 0; k < RPL; ++k) {
                const int c = __popc(x[k] & lrs);
                n_lt += c;
                if (!((a1t >> (rg + k * LPC)) & 1u)) n_ill += c;
            }
            n_lt = __reduce_add_sync(FULL, n_lt);
            n_ill = __reduce_add_sync(FULL, n_ill);
            words += PW;
            if (!(a2t == 0u && n_ill == 0)) {
                int prev = -1, cnt = -1, lack = n_lt;
                bool prog = true;
                while (prog && lack > 0) {
                    int b = __ffs(openm) - 1;
                    Slot sb = slot_of(sa1, sa2, st0, b);
                    for (uint32_t om = openm; om;) {
                        // the next open slot's words are fetched while
                        // this pass runs
                        const uint32_t rest = om & (om - 1);
                        const int nb = rest ? __ffs(rest) - 1 : b;
                        const Slot nsb = slot_of(sa1, sa2, st0, nb);
                        const uint32_t a1b = sb.a1, a2b = sb.a2;
                        const int t0b = sb.t0;
                        const uint32_t m = lrs & lackpat(b, col);
                        uint32_t red = 0u;
#pragma unroll
                        for (int k = 0; k < RPL; ++k)
                            if ((a2b >> (rg + k * LPC)) & 1u) red |= x[k] & m;
                        // OR over the lanes sharing the column (only
                        // lanes below PW hold rows < SnP)
                        if constexpr (NW == 1) {
                            red = __reduce_or_sync(FULL, red);
                        } else {
#pragma unroll
                            for (int o = NW; o < 32 && o < PW; o <<= 1)
                                red |= __shfl_xor_sync(FULL, red, o);
                        }
                        if (b < 5) {
                            const int sh = 1 << b;
#pragma unroll
                            for (int k = 0; k < RPL; ++k) {
                                const int s = rg + k * LPC;
                                uint32_t mv = ((a1b >> s) & 1u) ? (x[k] & m)
                                                                : 0u;
                                if (s == t0b) mv |= red;
                                x[k] |= mv << sh;
                            }
                        } else {
                            const int d = 1 << (b - 5);
                            const bool set = col & d;
#pragma unroll
                            for (int k = 0; k < RPL; ++k) {
                                const int s = rg + k * LPC;
                                uint32_t mv = ((a1b >> s) & 1u) ? (x[k] & m)
                                                                : 0u;
                                if (s == t0b) mv |= red;
                                const uint32_t y = __shfl_xor_sync(FULL, mv,
                                                                   d);
                                if (set) x[k] |= y;
                            }
                        }
                        words += b < 5 ? 2 * PW : PW;
                        om = rest;
                        b = nb;
                        sb = nsb;
                    }
                    int c = 0, l = 0;
#pragma unroll
                    for (int k = 0; k < RPL; ++k) {
                        c += __popc(x[k]);
                        l += __popc(x[k] & lrs);
                    }
                    c = __reduce_add_sync(FULL, c);
                    l = __reduce_add_sync(FULL, l);
                    words += PW;
                    prog = c > prev;
                    prev = c;
                    cnt = c;
                    lack = l;
                }
                // prune configs that never linearized rs (the bit stays
                // set: lazy retirement)
#pragma unroll
                for (int k = 0; k < RPL; ++k) x[k] &= ~lrs;
                words += 2 * PW;
                if (cnt >= 0 && cnt == lack) dead = g0 + r;
            }
            openm &= ~(1u << rs);
        }
        __syncwarp();
    }
    dead_out = dead;
    words_out = words;
}

// hidx (nullable): i32[gridDim.x], the history each CTA walks (the arm's
// share of the batch); null means CTA h walks history h.
template <int SnP>
__global__ void __launch_bounds__(32)
wgl_warp_kernel(const uint8_t *__restrict__ cbuf,
                const int64_t *__restrict__ offs,
                const int32_t *__restrict__ nrows,
                const int32_t *__restrict__ depth,
                const int32_t *__restrict__ hidx,
                const uint32_t *__restrict__ aux, int UP,
                int32_t *__restrict__ out, long long *__restrict__ work) {
    __shared__ uint32_t stage_buf[WEB * (1 + 4 * I)];
    const int h = hidx ? hidx[blockIdx.x] : blockIdx.x;
    const int Rh = depth[h];
    if (Rh < 1 || Rh > WARP_MAX_R) __trap();    // the caller broke the plan
    const Wire wr = wire_of(cbuf, offs, nrows, h);
    const Stage st = stage_at(stage_buf, WEB);
    int dead = -1;
    long long words = 0;
    switch (Rh > 5 ? Rh - 5 : 0) {
    case 0: warp_walk<0, SnP>(wr, st, aux, UP, dead, words); break;
    case 1: warp_walk<1, SnP>(wr, st, aux, UP, dead, words); break;
    case 2: warp_walk<2, SnP>(wr, st, aux, UP, dead, words); break;
    case 3: warp_walk<3, SnP>(wr, st, aux, UP, dead, words); break;
    case 4: warp_walk<4, SnP>(wr, st, aux, UP, dead, words); break;
    default: warp_walk<5, SnP>(wr, st, aux, UP, dead, words); break;
    }
    if (threadIdx.x == 0) {
        out[2 * h] = dead < 0 ? 1 : 0;
        out[2 * h + 1] = dead;
        if (work) work[h] = words;
    }
}

// ---------------------------------------------------------------------------
// Block arm: one CTA, thread t owns the columns t, t + T, ...
// ---------------------------------------------------------------------------

// Block-wide sums of two ints with one barrier; every thread gets both
// totals.  Warp partials go to the two buffers in turn: a warp cannot
// write a buffer again before every warp has passed the next sum's
// barrier, so no second barrier guards the reads.
__device__ __forceinline__ void block_sum2(int &x, int &y, int (*red)[64],
                                           int &par) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    x = __reduce_add_sync(FULL, x);
    y = __reduce_add_sync(FULL, y);
    if (lane == 0) {
        red[par][warp] = x;
        red[par][32 + warp] = y;
    }
    __syncthreads();
    const int nw = blockDim.x >> 5;
    x = __reduce_add_sync(FULL, lane < nw ? red[par][lane] : 0);
    y = __reduce_add_sync(FULL, lane < nw ? red[par][32 + lane] : 0);
    par ^= 1;
}

// Lazy-retirement merge at (re)registration of slot sl: configs that
// differ only in the vacant bit are one config, so fold the bit-set half
// onto the bit-clear half.
template <int SnP>
__device__ __forceinline__ void block_merge(uint32_t *fr, int NW, int sl) {
    const int tid = threadIdx.x, nt = blockDim.x;
    if (sl < 5) {
        const uint32_t lp = c_intra[sl];
        const int sh = 1 << sl;
        for (int w = tid; w < NW; w += nt)
#pragma unroll 8
            for (int s = 0; s < SnP; ++s) {
                const uint32_t x = fr[s * NW + w];
                const uint32_t y = (x & lp) | ((x & ~lp) >> sh);
                if (y != x) fr[s * NW + w] = y;
            }
    } else if (sl < 10) {                 // partner column in the warp
        const int d = 1 << (sl - 5);
        for (int w = tid; w < NW; w += nt) {
            const bool set = w & d;
#pragma unroll 8
            for (int s = 0; s < SnP; ++s) {
                const uint32_t x = fr[s * NW + w];
                const uint32_t y = __shfl_xor_sync(FULL, x, d);
                if (set) {
                    if (x) fr[s * NW + w] = 0u;
                } else if (y) {
                    fr[s * NW + w] = x | y;
                }
            }
        }
    } else {
        const int d = 1 << (sl - 5);
        const bool cross = d < nt;        // else the thread owns both
        if (cross) __syncthreads();
        for (int w = tid; w < NW; w += nt)
            if (!(w & d))
#pragma unroll 8
                for (int s = 0; s < SnP; ++s) {
                    const uint32_t y = fr[s * NW + (w | d)];
                    if (y) fr[s * NW + w] |= y;
                }
        if (cross) __syncthreads();
        for (int w = tid; w < NW; w += nt)
            if (w & d)
#pragma unroll 8
                for (int s = 0; s < SnP; ++s) fr[s * NW + w] = 0u;
    }
}

// One slot's pass of a Gauss-Seidel closure round toward the return of
// slot rs: linearize open slot b on every config lacking rs and b.  With
// `tally`, also add the plane's counts over the thread's own columns
// after the pass (c: configs, l: configs still lacking rs).
template <int SnP>
__device__ __forceinline__ void block_pass(uint32_t *fr, int NW, int b,
                                           int rs, uint32_t a1b,
                                           uint32_t a2b, int t0b,
                                           bool tally, int &c, int &l) {
    const int tid = threadIdx.x, nt = blockDim.x;
    if (b < 5) {                          // own words
        const uint32_t lb = c_intra[b];
        const int sh = 1 << b;
        for (int w = tid; w < NW; w += nt) {
            const uint32_t lrs = lackpat(rs, w), m = lrs & lb;
            if (!m && !tally) continue;
            uint32_t red = 0u;
            if (m)
#pragma unroll 8
                for (int s = 0; s < SnP; ++s)
                    if ((a2b >> s) & 1u) red |= fr[s * NW + w] & m;
#pragma unroll 8
            for (int s = 0; s < SnP; ++s) {
                uint32_t x = fr[s * NW + w];
                uint32_t mv = ((a1b >> s) & 1u) ? (x & m) : 0u;
                if (s == t0b) mv |= red;
                if (mv) {
                    x |= mv << sh;
                    fr[s * NW + w] = x;
                }
                if (tally) {
                    c += __popc(x);
                    l += __popc(x & lrs);
                }
            }
        }
    } else if (b < 10) {                  // the warp's 16 column pairs,
        const int k = b - 5, d = 1 << k;  // two lanes to a pair, each on
        const int lane = tid & 31;        // half of the state rows
        const int p = lane & 15, s0 = (lane >> 4) * (SnP / 2);
        const int off = ((p >> k) << (k + 1)) | (p & (d - 1));
        __syncwarp();                     // lanes read their neighbours'
        for (int g = tid - lane; g < NW; g += nt) {   // columns
            const int w = g + off;
            const uint32_t m = lackpat(rs, w);
            uint32_t red = 0u;
            if (m)
#pragma unroll
                for (int s = s0; s < s0 + SnP / 2; ++s)
                    if ((a2b >> s) & 1u) red |= fr[s * NW + w] & m;
            red |= __shfl_xor_sync(FULL, red, 16);
            if (!m) continue;
#pragma unroll
            for (int s = s0; s < s0 + SnP / 2; ++s) {
                uint32_t mv = ((a1b >> s) & 1u) ? (fr[s * NW + w] & m) : 0u;
                if (s == t0b) mv |= red;
                if (mv) fr[s * NW + (w | d)] |= mv;
            }
        }
        __syncwarp();
        if (tally)
            for (int w = tid; w < NW; w += nt) {
                const uint32_t lrs = lackpat(rs, w);
#pragma unroll 8
                for (int s = 0; s < SnP; ++s) {
                    const uint32_t x = fr[s * NW + w];
                    c += __popc(x);
                    l += __popc(x & lrs);
                }
            }
    } else {                              // owner pulls the source column
        const int d = 1 << (b - 5);
        if (d < nt) __syncthreads();
        for (int w = tid; w < NW; w += nt) {
            const uint32_t lrs = lackpat(rs, w);
            const uint32_t m = (w & d) ? lackpat(rs, w ^ d) : 0u;
            if (!m && !tally) continue;
            const uint32_t *src = fr + (w ^ d);
            uint32_t red = 0u;
            if (m)
#pragma unroll 8
                for (int s = 0; s < SnP; ++s)
                    if ((a2b >> s) & 1u) red |= src[s * NW] & m;
#pragma unroll 8
            for (int s = 0; s < SnP; ++s) {
                uint32_t x = fr[s * NW + w];
                if (m) {
                    uint32_t mv = ((a1b >> s) & 1u) ? (src[s * NW] & m) : 0u;
                    if (s == t0b) mv |= red;
                    if (mv & ~x) {
                        x |= mv;
                        fr[s * NW + w] = x;
                    }
                }
                if (tally) {
                    c += __popc(x);
                    l += __popc(x & lrs);
                }
            }
        }
    }
}

// Block arm with the plane in registers: thread t holds column t's SnP
// words (threads past the plane's NW columns hold zeros).  Cross-warp
// exchanges go through xb, two buffers of SnP x (T / 2) words used in
// turn, indexed by the column pair: the writer of one use and the
// reader of the use two later are ordered by the barrier between.
template <int SnP>
__global__ void __launch_bounds__(SnP == 32 ? 512 : 1024)
wgl_block_reg_kernel(const uint8_t *__restrict__ cbuf,
                     const int64_t *__restrict__ offs,
                     const int32_t *__restrict__ nrows,
                     const int32_t *__restrict__ depth,
                     const int32_t *__restrict__ hidx,
                     const uint32_t *__restrict__ aux, int UP, int R,
                     int32_t *__restrict__ out,
                     long long *__restrict__ work) {
    extern __shared__ uint32_t smem[];
    __shared__ int red[2][64];
    const int h = hidx ? hidx[blockIdx.x] : blockIdx.x;
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const int Rh = depth[h];
    if (Rh <= WARP_MAX_R || Rh > R) __trap();   // the caller broke the plan
    const int NW = 1 << (Rh - 5);
    const int PW = SnP * NW;
    const int half = nt >> 1;
    uint32_t *xb = smem;
    const Stage st = stage_at(smem + 2 * SnP * half, EB);
    const Wire wr = wire_of(cbuf, offs, nrows, h);

    // initial state is index 0 (interned first) at mask 0
    uint32_t x[SnP];
#pragma unroll
    for (int s = 0; s < SnP; ++s) x[s] = (tid == 0 && s == 0) ? 1u : 0u;
    uint32_t sa1 = 0u, sa2 = 0u, st0 = 0u, openm = 0u;
    int dead = -1, par = 0, xpar = 0;
    long long words = 0;    // plane words the passes touch (bound model)

    for (int g0 = 0; g0 < wr.L2 && dead < 0; g0 += EB) {
        const int nb = min(EB, wr.L2 - g0);
        stage_rows(wr, st, aux, UP, g0, nb, tid, nt);
        __syncthreads();
        for (int r = 0; r < nb && dead < 0; ++r) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = st.isl[r * I + i];
                if (sl < 0) continue;
                if (lane == sl) {
                    sa1 = st.a1[r * I + i];
                    sa2 = st.a2[r * I + i];
                    st0 = (uint32_t)st.t0[r * I + i];
                }
                openm |= 1u << sl;
                // lazy-retirement merge of the slot bit onto 0
                if (sl < 5) {
                    const uint32_t lp = c_intra[sl];
                    const int sh = 1 << sl;
#pragma unroll
                    for (int s = 0; s < SnP; ++s)
                        x[s] = (x[s] & lp) | ((x[s] & ~lp) >> sh);
                } else {
                    const int k = sl - 5, d = 1 << k;
                    const bool set = tid & d;
                    if (sl < 10) {
#pragma unroll
                        for (int s = 0; s < SnP; ++s) {
                            const uint32_t y = __shfl_xor_sync(FULL, x[s], d);
                            x[s] = set ? 0u : (x[s] | y);
                        }
                    } else {
                        uint32_t *buf = xb + xpar * SnP * half +
                            (((tid >> (k + 1)) << k) | (tid & (d - 1)));
                        if (set)
#pragma unroll
                            for (int s = 0; s < SnP; ++s) buf[s * half] = x[s];
                        __syncthreads();
#pragma unroll
                        for (int s = 0; s < SnP; ++s)
                            x[s] = set ? 0u : (x[s] | buf[s * half]);
                        xpar ^= 1;
                    }
                }
                words += 2 * PW;
            }
            const int rs = st.ret[r];
            if (rs < 0) continue;

            // a pure op legal on every config still lacking it is the
            // identity on the plane
            const uint32_t lrs = lackpat(rs, tid);
            const uint32_t a1t = bcast(sa1, rs), a2t = bcast(sa2, rs);
            int n_lt = 0, n_ill = 0;
#pragma unroll
            for (int s = 0; s < SnP; ++s) {
                const int c = __popc(x[s] & lrs);
                n_lt += c;
                if (!((a1t >> s) & 1u)) n_ill += c;
            }
            block_sum2(n_lt, n_ill, red, par);
            words += PW;
            if (!(a2t == 0u && n_ill == 0)) {
                int prev = -1, cnt = -1, lack = n_lt;
                bool prog = true;
                while (prog && lack > 0) {
                    int b = __ffs(openm) - 1;
                    Slot sb = slot_of(sa1, sa2, st0, b);
                    for (uint32_t om = openm; om;) {
                        // the next open slot's words are fetched while
                        // this pass runs
                        const uint32_t rest = om & (om - 1);
                        const int nb = rest ? __ffs(rest) - 1 : b;
                        const Slot nsb = slot_of(sa1, sa2, st0, nb);
                        const uint32_t a1b = sb.a1, a2b = sb.a2;
                        const int t0b = sb.t0;
                        const uint32_t m = lrs & lackpat(b, tid);
                        uint32_t rd = 0u;
#pragma unroll
                        for (int s = 0; s < SnP; ++s)
                            if ((a2b >> s) & 1u) rd |= x[s] & m;
                        if (b < 5) {                  // own words
                            const int sh = 1 << b;
#pragma unroll
                            for (int s = 0; s < SnP; ++s) {
                                uint32_t mv = ((a1b >> s) & 1u) ? (x[s] & m)
                                                                : 0u;
                                if (s == t0b) mv |= rd;
                                x[s] |= mv << sh;
                            }
                        } else if (b < 10) {          // shuffle in the warp
                            const int d = 1 << (b - 5);
                            const bool set = tid & d;
#pragma unroll
                            for (int s = 0; s < SnP; ++s) {
                                uint32_t mv = ((a1b >> s) & 1u) ? (x[s] & m)
                                                                : 0u;
                                if (s == t0b) mv |= rd;
                                const uint32_t y = __shfl_xor_sync(FULL, mv,
                                                                   d);
                                if (set) x[s] |= y;
                            }
                        } else {                      // through xb
                            const int k = b - 5, d = 1 << k;
                            const bool set = tid & d;
                            uint32_t *buf = xb + xpar * SnP * half +
                                (((tid >> (k + 1)) << k) | (tid & (d - 1)));
                            if (!set)
#pragma unroll
                                for (int s = 0; s < SnP; ++s) {
                                    uint32_t mv = ((a1b >> s) & 1u)
                                                      ? (x[s] & m) : 0u;
                                    if (s == t0b) mv |= rd;
                                    buf[s * half] = mv;
                                }
                            __syncthreads();
                            if (set)
#pragma unroll
                                for (int s = 0; s < SnP; ++s)
                                    x[s] |= buf[s * half];
                            xpar ^= 1;
                        }
                        words += b < 5 ? 2 * PW : PW;
                        om = rest;
                        b = nb;
                        sb = nsb;
                    }
                    int c = 0, l = 0;
#pragma unroll
                    for (int s = 0; s < SnP; ++s) {
                        c += __popc(x[s]);
                        l += __popc(x[s] & lrs);
                    }
                    block_sum2(c, l, red, par);
                    words += PW;
                    prog = c > prev;
                    prev = c;
                    cnt = c;
                    lack = l;
                }
                // prune configs that never linearized rs (the bit stays
                // set: lazy retirement)
#pragma unroll
                for (int s = 0; s < SnP; ++s) x[s] &= ~lrs;
                words += 2 * PW;
                if (cnt >= 0 && cnt == lack) dead = g0 + r;
            }
            openm &= ~(1u << rs);
        }
        __syncthreads();
    }
    if (tid == 0) {
        out[2 * h] = dead < 0 ? 1 : 0;
        out[2 * h + 1] = dead;
        if (work) work[h] = words;
    }
}

// The plane lives in dynamic shared memory (gplane null) or at gplane +
// CTA * stride (R = 16 at SnP = 32); the staged event block follows the
// plane in shared memory, or starts it.
template <int SnP>
__global__ void __launch_bounds__(1024, 1)
wgl_block_kernel(const uint8_t *__restrict__ cbuf,
                 const int64_t *__restrict__ offs,
                 const int32_t *__restrict__ nrows,
                 const int32_t *__restrict__ depth,
                 const int32_t *__restrict__ hidx,
                 const uint32_t *__restrict__ aux, int UP, int R,
                 uint32_t *__restrict__ gplane,
                 int32_t *__restrict__ out, long long *__restrict__ work) {
    extern __shared__ uint32_t smem[];
    __shared__ int red[2][64];
    const int cta = blockIdx.x;
    const int h = hidx ? hidx[cta] : cta;
    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const int Rh = depth[h];
    if (Rh <= WARP_MAX_R || Rh > R) __trap();   // the caller broke the plan
    const int NW = 1 << (Rh - 5);
    const int PW = SnP * NW;
    const int stride = SnP << (R - 5);
    uint32_t *fr = gplane ? gplane + (size_t)cta * stride : smem;
    const Stage st = stage_at(gplane ? smem : smem + stride, EB);
    const Wire wr = wire_of(cbuf, offs, nrows, h);

    // initial state is index 0 (interned first) at mask 0
    for (int w = tid; w < NW; w += nt)
        for (int s = 0; s < SnP; ++s)
            fr[s * NW + w] = (s == 0 && w == 0) ? 1u : 0u;
    uint32_t sa1 = 0u, sa2 = 0u, st0 = 0u, openm = 0u;
    int dead = -1, par = 0;
    long long words = 0;    // plane words the passes touch (bound model)

    for (int g0 = 0; g0 < wr.L2 && dead < 0; g0 += EB) {
        const int nb = min(EB, wr.L2 - g0);
        stage_rows(wr, st, aux, UP, g0, nb, tid, nt);
        __syncthreads();
        for (int r = 0; r < nb && dead < 0; ++r) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = st.isl[r * I + i];
                if (sl < 0) continue;
                if (lane == sl) {
                    sa1 = st.a1[r * I + i];
                    sa2 = st.a2[r * I + i];
                    st0 = (uint32_t)st.t0[r * I + i];
                }
                openm |= 1u << sl;
                block_merge<SnP>(fr, NW, sl);
                words += 2 * PW;
            }
            const int rs = st.ret[r];
            if (rs < 0) continue;

            // a pure op legal on every config still lacking it is the
            // identity on the plane
            const uint32_t a1t = bcast(sa1, rs), a2t = bcast(sa2, rs);
            int n_lt = 0, n_ill = 0;
            for (int w = tid; w < NW; w += nt) {
                const uint32_t lrs = lackpat(rs, w);
                if (!lrs) continue;
#pragma unroll 8
                for (int s = 0; s < SnP; ++s) {
                    const int c = __popc(fr[s * NW + w] & lrs);
                    n_lt += c;
                    if (!((a1t >> s) & 1u)) n_ill += c;
                }
            }
            block_sum2(n_lt, n_ill, red, par);
            words += PW;
            if (!(a2t == 0u && n_ill == 0)) {
                int prev = -1, cnt = -1, lack = n_lt;
                bool prog = true;
                while (prog && lack > 0) {
                    int c = 0, l = 0;
                    for (uint32_t om = openm; om; om &= om - 1) {
                        const int b = __ffs(om) - 1;
                        block_pass<SnP>(fr, NW, b, rs, bcast(sa1, b),
                                        bcast(sa2, b), (int)bcast(st0, b),
                                        (om & (om - 1)) == 0, c, l);
                        words += b < 5 ? 2 * PW : PW;
                    }
                    block_sum2(c, l, red, par);
                    words += PW;
                    prog = c > prev;
                    prev = c;
                    cnt = c;
                    lack = l;
                }
                // prune configs that never linearized rs (the bit stays
                // set: lazy retirement)
                for (int w = tid; w < NW; w += nt) {
                    const uint32_t lrs = lackpat(rs, w);
                    if (!lrs) continue;
#pragma unroll 8
                    for (int s = 0; s < SnP; ++s) fr[s * NW + w] &= ~lrs;
                }
                words += 2 * PW;
                if (cnt >= 0 && cnt == lack) dead = g0 + r;
            }
            openm &= ~(1u << rs);
        }
        __syncthreads();
    }
    if (tid == 0) {
        out[2 * h] = dead < 0 ? 1 : 0;
        out[2 * h + 1] = dead;
        if (work) work[h] = words;
    }
}

// ---------------------------------------------------------------------------
// Launchers: one grid on `stream`; each returns the launch's cudaError_t
// (0 on success).  n is the number of CTAs (histories of the arm).
// ---------------------------------------------------------------------------

extern "C" int wgl_deep_warp_launch(const void *cbuf, const void *offs,
                                    const void *nrows, const void *depth,
                                    const void *hidx, const void *aux,
                                    int UP, int n, int SnP, void *out,
                                    void *work, void *stream) {
    void (*kern)(const uint8_t *, const int64_t *, const int32_t *,
                 const int32_t *, const int32_t *, const uint32_t *, int,
                 int32_t *, long long *) =
        SnP == 8 ? wgl_warp_kernel<8>
        : SnP == 16 ? wgl_warp_kernel<16>
        : SnP == 32 ? wgl_warp_kernel<32> : nullptr;
    if (!kern) return (int)cudaErrorInvalidValue;
    kern<<<n, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)cbuf, (const int64_t *)offs,
        (const int32_t *)nrows, (const int32_t *)depth,
        (const int32_t *)hidx, (const uint32_t *)aux, UP, (int32_t *)out,
        (long long *)work);
    return (int)cudaGetLastError();
}

// regs selects the plane in registers (xb and the staged block in
// smem_bytes of dynamic shared memory); otherwise smem_bytes is the
// staged event block, plus the plane when gplane is null.
extern "C" int wgl_deep_block_launch(const void *cbuf, const void *offs,
                                     const void *nrows, const void *depth,
                                     const void *hidx, const void *aux,
                                     int UP, int n, int R, int SnP,
                                     int regs, void *gplane, void *out,
                                     void *work, int threads,
                                     int smem_bytes, void *stream) {
    cudaError_t err;
    if (regs) {
        void (*kern)(const uint8_t *, const int64_t *, const int32_t *,
                     const int32_t *, const int32_t *, const uint32_t *,
                     int, int, int32_t *, long long *) =
            SnP == 8 ? wgl_block_reg_kernel<8>
            : SnP == 16 ? wgl_block_reg_kernel<16>
            : SnP == 32 ? wgl_block_reg_kernel<32> : nullptr;
        if (!kern) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return (int)err;
        kern<<<n, threads, smem_bytes, (cudaStream_t)stream>>>(
            (const uint8_t *)cbuf, (const int64_t *)offs,
            (const int32_t *)nrows, (const int32_t *)depth,
            (const int32_t *)hidx, (const uint32_t *)aux, UP, R,
            (int32_t *)out, (long long *)work);
        return (int)cudaGetLastError();
    }
    void (*kern)(const uint8_t *, const int64_t *, const int32_t *,
                 const int32_t *, const int32_t *, const uint32_t *, int,
                 int, uint32_t *, int32_t *, long long *) =
        SnP == 8 ? wgl_block_kernel<8>
        : SnP == 16 ? wgl_block_kernel<16>
        : SnP == 32 ? wgl_block_kernel<32> : nullptr;
    if (!kern) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<n, threads, smem_bytes, (cudaStream_t)stream>>>(
        (const uint8_t *)cbuf, (const int64_t *)offs,
        (const int32_t *)nrows, (const int32_t *)depth,
        (const int32_t *)hidx, (const uint32_t *)aux, UP, R,
        (uint32_t *)gplane, (int32_t *)out, (long long *)work);
    return (int)cudaGetLastError();
}
