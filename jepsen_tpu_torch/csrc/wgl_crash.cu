// The register-delta segment scan's crash variants, for Hopper (sm_90a).
//
// Replaces the nc > 0, crash_closure and death_row variants of
// jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs (:258, an XLA lax.scan,
// not Pallas; :290-316, :324-462, :474-484), and the composed relaxed
// wrapper _build_kernel_regs_relaxed (:564).  One walk, three uses:
//
//   crash   nc crashed calls hold permanent slots rn..rn+nc-1: registered
//           like invokes (the wire registers every open crashed call at
//           a segment's start), never retired.  Lane j = cm * Sn + s
//           enters in state s at mask cm << rn; its transfer row reads the
//           2^nc crashed-mask planes at zero normal bits: out[K][J][J],
//           J = Sn * 2^nc <= 128.
//   relaxed nc = 0, lane j enters in state j at mask 0 (J = Sn); each row
//           names a row of ctab[nC][Sn] (bit t of ctab[c][s]: the jump
//           s -> t is allowed; reflexive and transitive, built on the
//           host), whose masks close the plane's states after the row's
//           registrations and after every round: out[K][Sn][Sn].
//   death   the relaxed walk of one lane seeded with the states of `seed`
//           at mask 0; dout[k] is the first row (virtual rows counted)
//           after which the plane is empty, or -1.  The walk stops there.
//
// State.  A lane's plane is fr[SnP][WD] of 32-bit words, WD = max(1,
// 2^R / 32) (R = rn + nc counts the crashed slots, up to 8, so WD <= 8):
// bit i of word w is the linearized-call set w * 32 + i.  Slot b < 5
// moves bits inside a word; slot b >= 5 is bit b - 5 of the word index.
//
// The walk, per event row: register up to I = 2 invokes (slot b's a1, a2,
// t0 words; the slot opens); [relaxed, death: close the states]; when a
// slot is open, rounds to the fixpoint (at most R), each a pass of every
// open slot b in order (the configs lacking b: moved = contrib & diag(a1),
// and at state t0 the OR over states of contrib & const(a2), set into b)
// [then close the states]; at a return of slot rs, prune the configs
// lacking rs and clear its bit, and retire the slot.  R rounds reach the
// fixpoint, so each pass updates the plane in place (Gauss-Seidel): a
// round then holds at least what the reference's Jacobi round holds and
// no more than the fixpoint, and the transfer rows are the same bit for
// bit.  Inside one pass the update is the Jacobi one, since a pass only
// sets bits its sources lack.  A warp leaves the row's rounds when a
// ballot finds that no lane of it changed (a lane that did not change is
// at its fixpoint and stays there).
//
// Two-word state masks (W = 2, the relaxed tier's lift to 33..64 states,
// jepsen_tpu/ops/wgl_seg.py:565-612 with sn_words=2): every per-state mask
// (aux a1[UP][W] ++ a2[UP][W] ++ t0[UP], ctab[nC][Sn][W], the death row's
// 64-bit seed) holds state s in word s / 32, and a thread keeps two state
// rows, s and s + 32, so a lane of 64 rows stays one warp: the rank-1 OR
// and the closure stay shuffles (a source row's thread s % 32, its row s /
// 32), a row stages 32 event rows a chunk (its closure masks take 512
// bytes a row).  With W = 1 every shape and name below is the one-row
// case.
//
// Layout.  One thread per (lane j, state row s), as wgl_regs.cu: a
// lane's SnP rows sit on SnP consecutive threads of one warp (4, 2 or 1
// lanes a warp at SnP 8, 16 or 32), and each thread keeps its row's WD
// words in registers.  Every pass is then inside the thread at any slot:
// a slot b < 5 pass moves bits inside each word, a slot b >= 5 pass and
// prune move whole words between registers (word w to w | (1 << (b -
// 5))), with no shuffle.  The rank-1 term, an OR over the lane's state
// rows, is a __shfl_xor_sync tree inside the lane's SnP threads where
// the slot's const mask holds several states, one indexed shuffle where
// it holds one, none where it holds none; the branch is the slot's, so
// each pass runs one of three straight loops over the words.  The state
// closure is computed across the lane's threads: target row t ORs in
// row s's words (an indexed shuffle) for each source s whose ctab mask
// allows s -> t; row t reads its column of the row's masks once a row.
// A row whose masks let no state jump skips the closure, and so does a
// round whose passes changed no lane of the warp (the plane was closed
// when the round began), so each row's last round is passes only.
//
// CTAs.  A segment's J lanes (J * SnP threads, up to 4096) split over
// the fewest CTAs of at most MAXT = 128 threads, on grid y ((c)'s J = 88
// at SnP 16: 11 CTAs of 8 lanes), and every CTA stages the same rows.
// Small CTAs pack an SM's warps finely (a CTA leaves its SM when its
// segment ends) and spread a launch of few segments, as the relaxed
// tier's, over more SMs, so fewer of its chains share one.  Not a
// thread-block cluster: the rows a CTA stages are a few bytes each (7,
// or 9 and the row's SnP masks with the closure), read from L2 once per
// 64 rows, so one copy shared over distributed shared memory would save
// a load per chunk, cost a cluster barrier per chunk, and tie a
// segment's CTAs to neighbouring SMs.  A CTA stages CHUNK event rows at
// a time into shared memory, double buffered: the next chunk's wire
// bytes are loaded into registers before the walk of this one and
// stored after it, one __syncthreads a chunk.  Every decision in the
// walk (the open slots, the returning slot, the closure's sources) is
// the segment's, so no warp diverges.
//
// What bounds it on this card.  The crash variant at (c)'s shapes:
// integer operations, issued by 295 x 88 lanes of 16 threads (11 rows
// that hold configs, 5 padding): the counted ones below, plus what the
// count leaves out (the rank-1 shuffles, the mask selects, ballots and
// the row's shared loads).  It is capped at 64 registers a thread, so
// an SM holds 8 of its CTAs (32 warps) to hide each warp's latency.  The
// relaxed variant and the death row: the latency of one segment's rows
// walked as one dependent chain ((b)'s longest segment has 1577 rows).
// The design shortens that chain where it can: passes need no shuffle
// at b >= 5, the closure's shuffles are independent of each other (one
// step deep, not a loop over the rows in one thread), the row's closure
// column is read once for all its rounds, the last round skips the
// closure, and a warp leaves a row's rounds at its lanes' fixpoint.  The slot passes of one round stay a
// chain (each reads the plane the previous pass left, as the plain
// version's count needs).
//
// The work= count, the plain version's (crash_kernel.walk_plain), which
// the kernel is held to: a lane's plane is at most 8 words per thread,
// in registers; the wire is 7 (9 with the closure) bytes a row.  Per row
// and lane it charges a pass of slot b < 5 CLOSE_OPS per word of the Sn
// live state rows, of slot b >= 5 CLOSE5_OPS per state row of each
// receiving word (WD / 2), a prune PRUNE_OPS per word (per state row and
// receiving word at b >= 5), a state closure CLOSURE_OPS per (source,
// target) pair and word, before the rounds and in every round; and each
// round the lane runs up to the first that leaves its plane unchanged (at
// most R), not the rounds its warp runs on for other lanes.  It charges
// closures that change nothing, which the walk skips: at a row whose
// masks let no state jump, and in a round whose passes left the lane
// unchanged.  walk_plain's `need` count leaves those out; the bound is
// taken from it.  Each lane's count is added once, from its first row's
// thread (a warp's sum, one atomic a warp), to work[k], which the caller
// zeroes.
//
// Wire: segment k's L = nrows[k] rows at byte offs[k]: ret+1 u8[L] ++
// islot+1 u8[L * 2] ++ iuop u16-LE[L * 2] (++ crow i16-LE[L] with the
// closure).  aux is diag[UP] ++ const[UP] ++ t0[UP].  A segment whose rows
// lie outside cbuf, or name a uop outside the table, a slot at or past R
// or a crow outside ctab, adds one to *bad and writes no output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXR = 8;          // deepest R = rn + nc the kernel walks
constexpr int I = 2;             // invoke columns per event row
constexpr int MAXT = 128;        // threads a CTA at most
// CTAs an SM must hold at once (the crash variant: at most 64 registers
// a thread; the relaxed variant and the death row take what they need)
constexpr int MIN_CTAS = 65536 / (64 * MAXT);
constexpr uint32_t FULL = 0xFFFFFFFFu;
// integer operations of the work count (the bound model of the note)
constexpr int CLOSE_OPS = 6;     // per word of a slot b < 5 pass
constexpr int CLOSE5_OPS = 4;    // per state row and receiving word, b >= 5
constexpr int PRUNE_OPS = 2;     // per word (receiving word at b >= 5)
constexpr int CLOSURE_OPS = 2;   // per (source, target) pair and word

// Event rows staged per step: 64, or 32 with two-word state masks (the
// row's closure masks then take 512 bytes).
template <int W>
__host__ __device__ constexpr int chunk() { return W == 1 ? 64 : 32; }

// Bit i of intra(b) is set iff mask index i lacks bit b (b < 5).
__host__ __device__ constexpr uint32_t intra(int b) {
    return b == 0 ? 0x55555555u : b == 1 ? 0x33333333u
           : b == 2 ? 0x0F0F0F0Fu : b == 3 ? 0x00FF00FFu : 0x0000FFFFu;
}

// The rank-1 term's sources of a uop, from its const mask a2: none,
// one state (its index), or many; a slot's kind of sources.
constexpr int SRC_NONE = -1;
constexpr int SRC_MANY = 255;
constexpr int SRC_KIND_NONE = 0;
constexpr int SRC_KIND_ONE = 1;
constexpr int SRC_KIND_MANY = 2;

template <int SNP, bool CLOSE, int W>
struct Stage {
    int32_t ret[chunk<W>()];
    int32_t slot[chunk<W>()][I];
    int32_t t0[chunk<W>()][I];
    int32_t src[chunk<W>()][I];
    uint32_t a1[chunk<W>()][I][W];
    uint32_t a2[chunk<W>()][I][W];
    // the row's ctab masks (0 past Sn; word w of source q's mask holds
    // targets 32 w ..), and whether some source may jump to another
    // live state
    uint32_t cmask[CLOSE ? chunk<W>() : 1][SNP * W][W];
    uint32_t csrc[CLOSE ? chunk<W>() : 1];
};

// OR of v over the SNP consecutive threads of this thread's lane.
template <int SNP>
__device__ __forceinline__ uint32_t or_lane(uint32_t v) {
#pragma unroll
    for (int m = 1; m < SNP; m <<= 1) v |= __shfl_xor_sync(FULL, v, m, SNP);
    return v;
}

// All ones where bit B of x is set.
template <int B>
__device__ __forceinline__ uint32_t ones_if(uint32_t x) {
    return uint32_t(int32_t(x << (31 - B)) >> 31);
}

// One pass of slot B over this thread's W state rows (row h is state s +
// SNP h), in place, OR-ing the bits it adds into `grew`.  Bit B of
// dbits / cbits / tbits [h]: row h is in the slot's a1, in its a2, is its
// target state t0; kind, src: the slot's rank-1 sources (the segment's,
// so the branch is uniform): none, one row (bits 0-4: the warp thread
// that holds it, bit 5: which of its rows), or many (an OR over the
// lane of the words of the rows in a2).
template <int WD, int SNP, int W, int B>
__device__ __forceinline__ void pass(uint32_t (&fr)[W][WD], uint32_t &grew,
                                     const uint32_t (&dbits)[W],
                                     const uint32_t (&cbits)[W],
                                     const uint32_t (&tbits)[W], int kind,
                                     int src) {
    // word w holds configs lacking the slot (all of them at b < 5, none
    // at b >= 5 if bit b - 5 of w is set) and sends them to word w | H
    constexpr int H = B < 5 ? 0 : 1 << (B - 5);
    auto src_word = [&](int h, int w) {
        if constexpr (B < 5) return fr[h][w] & intra(B);
        else return fr[h][w];
    };
    auto add = [&](int h, int w, uint32_t moved) {
        if constexpr (B < 5) moved <<= 1 << B;
        grew |= moved & ~fr[h][w];
        fr[h][w] |= moved;
    };
    if constexpr (B >= 5 && H >= WD) {
        return;
    } else {
#pragma unroll
        for (int w = 0; w < WD; ++w) {
            if (w & H) continue;
            uint32_t x[W];
#pragma unroll
            for (int h = 0; h < W; ++h) x[h] = src_word(h, w);
            uint32_t r1 = 0u;            // the rank-1 term's OR
            if (kind == SRC_KIND_MANY) {
                uint32_t v = 0u;
#pragma unroll
                for (int h = 0; h < W; ++h) v |= x[h] & ones_if<B>(cbits[h]);
                r1 = or_lane<SNP>(v);
            } else if (kind == SRC_KIND_ONE) {
                const uint32_t pick = W > 1 && (src & 32) ? x[W - 1] : x[0];
                r1 = __shfl_sync(FULL, pick, src & 31);
            }
#pragma unroll
            for (int h = 0; h < W; ++h)
                add(h, w | H, (x[h] & ones_if<B>(dbits[h]))
                                  | (r1 & ones_if<B>(tbits[h])));
        }
    }
}

// Prune the configs lacking slot B and clear its bit.
template <int WD, int W, int B>
__device__ __forceinline__ void retire(uint32_t (&fr)[W][WD]) {
#pragma unroll
    for (int h = 0; h < W; ++h) {
        if constexpr (B < 5) {
#pragma unroll
            for (int w = 0; w < WD; ++w)
                fr[h][w] = (fr[h][w] & ~intra(B)) >> (1 << B);
        } else if constexpr ((1 << (B - 5)) < WD) {
            constexpr int H = 1 << (B - 5);
#pragma unroll
            for (int w = 0; w < WD; ++w) {
                if (w & H) continue;
                fr[h][w] = fr[h][w | H];
                fr[h][w | H] = 0u;
            }
        }
    }
}

// Close the lane's states under the row's jumps, in place: row h takes
// every row q with q -> (s + SNP h) allowed (bit q % 32 of col[h][q /
// 32]).  The shuffles are independent of each other, so they issue back
// to back.  Reading rows before the closure gives the closed set, since
// the jumps are transitive.
template <int WD, int SNP, int W>
__device__ __forceinline__ void close_states(uint32_t (&fr)[W][WD],
                                             const uint32_t (&col)[W][W],
                                             int lane0) {
    uint32_t acc[W][WD];
#pragma unroll
    for (int h = 0; h < W; ++h)
#pragma unroll
        for (int w = 0; w < WD; ++w) acc[h][w] = fr[h][w];
#pragma unroll
    for (int q = 0; q < SNP * W; ++q) {
#pragma unroll
        for (int w = 0; w < WD; ++w) {
            const uint32_t v = __shfl_sync(FULL, fr[q / SNP][w],
                                           lane0 + q % SNP);
#pragma unroll
            for (int h = 0; h < W; ++h)
                acc[h][w] |= v & (0u - ((col[h][q / 32] >> (q % 32)) & 1u));
        }
    }
#pragma unroll
    for (int h = 0; h < W; ++h)
#pragma unroll
        for (int w = 0; w < WD; ++w) fr[h][w] = acc[h][w];
}

}  // namespace

template <int WD, int SNP, bool CLOSE, int W>
__global__ void __launch_bounds__(MAXT, CLOSE ? 1 : MIN_CTAS)
wgl_crash_kernel(const uint8_t *__restrict__ cbuf, long long nbytes,
                 const int64_t *__restrict__ offs,
                 const int32_t *__restrict__ nrows,
                 const uint32_t *__restrict__ aux, int UP,
                 const uint32_t *__restrict__ ctab, int nC, int R, int Sn,
                 int nc, int rn, int J, int LPC, int death,
                 unsigned long long seed, void *__restrict__ out,
                 long long *__restrict__ work, int32_t *__restrict__ bad) {
    constexpr int CHUNK = chunk<W>();
    __shared__ Stage<SNP, CLOSE, W> stage[2];
    constexpr int CELLS = CHUNK * I;
    constexpr int CPT = CELLS / 32;     // staged cells a thread, at most
    constexpr int RPT = CHUNK / 32;     // staged rows a thread, at most
    constexpr int RB = 1 + 3 * I + (CLOSE ? 2 : 0);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31;
    const int jl = tid / SNP;           // the lane inside this CTA
    const int j = blockIdx.y * LPC + jl;
    const int s = tid % SNP;            // this thread's first state row
    const uint32_t gmask =
        SNP == 32 ? FULL : ((1u << (SNP & 31)) - 1u) << (lane & ~(SNP - 1));
    const bool real = jl < LPC && j < J;
    const int k = blockIdx.x;
    const long long off = offs[k];
    const int L = nrows[k];
    if (L < 0 || off < 0 || off + (long long)RB * L > nbytes) {
        if (tid == 0 && blockIdx.y == 0) atomicAdd(bad, 1);
        return;                         // the whole CTA leaves together
    }
    const uint8_t *ret_b = cbuf + off;
    const uint8_t *isl_b = ret_b + L;
    const uint8_t *iu_b = ret_b + 3LL * L;
    const uint8_t *cr_b = ret_b + 7LL * L;
    uint32_t live[W];                   // word w: the live states 32 w ..
#pragma unroll
    for (int w = 0; w < W; ++w)
        live[w] = Sn >= 32 * (w + 1) ? FULL
                  : Sn <= 32 * w ? 0u : (1u << (Sn - 32 * w)) - 1u;
    int refused = 0;                    // this thread staged a bad cell

    // the next chunk's wire bytes, loaded before a walk, stored after it:
    // a row's ret+1 byte (and crow u16 above it), a cell's islot+1 byte
    // and iuop u16 above it
    uint32_t p_row[RPT], p_cell[CPT];
    auto fetch = [&](int base) {
        const int n = min(CHUNK, L - base);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
            const int r = tid + q * nt;
            p_row[q] = 0u;
            if (r < n) {
                p_row[q] = ret_b[base + r];
                if (CLOSE) {
                    const long long c = 2LL * (base + r);
                    p_row[q] |= uint32_t(cr_b[c]) << 8
                                | uint32_t(cr_b[c + 1]) << 16;
                }
            }
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
            const int x = tid + q * nt;
            p_cell[q] = 0u;
            if (x < n * I) {
                const long long c = (long long)base * I + x;
                p_cell[q] = uint32_t(isl_b[c]) | uint32_t(iu_b[2 * c]) << 8
                            | uint32_t(iu_b[2 * c + 1]) << 16;
            }
        }
    };
    auto store = [&](Stage<SNP, CLOSE, W> &st, int base) {
        const int n = min(CHUNK, L - base);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
            const int r = tid + q * nt;
            if (r >= n) continue;
            int rs = int(p_row[q] & 0xFFu) - 1;
            if (rs >= R) {
                refused = 1;
                rs = -1;
            }
            st.ret[r] = rs;
            if constexpr (CLOSE) {
                int cr = int(int16_t(uint16_t(p_row[q] >> 8)));
                if (cr < 0 || cr >= nC) {
                    refused = 1;
                    cr = 0;
                }
                uint32_t jumps = 0u;
#pragma unroll
                for (int q2 = 0; q2 < SNP * W; ++q2) {
#pragma unroll
                    for (int w = 0; w < W; ++w) {
                        const uint32_t m =
                            q2 < Sn ? ctab[((long long)cr * Sn + q2) * W + w]
                                    : 0u;
                        st.cmask[r][q2][w] = m;
                        const uint32_t self =
                            q2 / 32 == w ? 1u << (q2 % 32) : 0u;
                        jumps |= m & live[w] & ~self;
                    }
                }
                st.csrc[r] = jumps != 0u;
            }
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
            const int x = tid + q * nt;
            if (x >= n * I) continue;
            int sl = int(p_cell[q] & 0xFFu) - 1;
            const int u = int(p_cell[q] >> 8);
            if (sl >= 0 && (u >= UP || sl >= R)) {
                refused = 1;
                sl = -1;
            }
            st.slot[x / I][x % I] = sl;
            if (sl >= 0) {
                int n2 = 0, one = SRC_NONE;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    const uint32_t a2 = aux[(long long)W * UP + u * W + w];
                    st.a1[x / I][x % I][w] = aux[u * W + w];
                    st.a2[x / I][x % I][w] = a2;
                    n2 += __popc(a2);
                    if (a2 && one == SRC_NONE) one = 32 * w + __ffs(a2) - 1;
                }
                st.t0[x / I][x % I] = int(aux[2LL * W * UP + u]);
                st.src[x / I][x % I] = n2 == 0 ? SRC_NONE
                                       : n2 > 1 ? SRC_MANY : one;
            }
        }
    };

    uint32_t fr[W][WD];
    {
#pragma unroll
        for (int h = 0; h < W; ++h) {
            const int st = s + SNP * h;     // this row's state
            int w0 = -1;                    // the word of the entry config
            uint32_t v = 0u;
            if (real && death) {
                w0 = 0;
                v = st < Sn ? uint32_t((seed >> st) & 1ull) : 0u;
            } else if (real && st == j % Sn) {
                const int m0 = (j / Sn) << rn;
                w0 = m0 >> 5;
                v = 1u << (m0 & 31);
            }
#pragma unroll
            for (int w = 0; w < WD; ++w) fr[h][w] = w == w0 ? v : 0u;
        }
    }
    // bit b of dbits / cbits / tbits [h]: row h is in slot b's a1, in its
    // a2, is its t0; 2-bit field b of kinds: slot b's rank-1 sources
    // (none, one, many), 6-bit field b of srcs: the warp thread (bits 0-4)
    // and row (bit 5) of the one
    uint32_t dbits[W], cbits[W], tbits[W];
#pragma unroll
    for (int h = 0; h < W; ++h) dbits[h] = cbits[h] = tbits[h] = 0u;
    uint32_t kinds = 0u;
    unsigned long long srcs = 0ull;
    const int lane0 = lane & ~(SNP - 1);    // the lane's first thread
    uint32_t open = 0u;                 // bit b: slot b is open
    // this thread's lane's passes and prunes at slots b < 5 and b >= 5,
    // and its closures: the terms of its work count
    uint32_t n_pass = 0u, n_pass5 = 0u, n_prune = 0u, n_prune5 = 0u;
    uint32_t n_close = 0u;
    int dead = -1;

    if (L > 0) {
        fetch(0);
        store(stage[0], 0);
    }
    __syncthreads();
    for (int base = 0, c = 0; base < L; base += CHUNK, ++c) {
        const int n = min(CHUNK, L - base);
        const bool more = base + CHUNK < L;
        if (more) fetch(base + CHUNK);
        const Stage<SNP, CLOSE, W> &st = stage[c & 1];
        for (int r = 0; r < n; ++r) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = st.slot[r][i];
                if (sl < 0) continue;
                const uint32_t bit = 1u << sl, keep = ~bit;
#pragma unroll
                for (int h = 0; h < W; ++h) {
                    const int sh = s + SNP * h;
                    dbits[h] = (dbits[h] & keep)
                        | (((st.a1[r][i][sh / 32] >> (sh % 32)) & 1u) << sl);
                    cbits[h] = (cbits[h] & keep)
                        | (((st.a2[r][i][sh / 32] >> (sh % 32)) & 1u) << sl);
                    tbits[h] = (tbits[h] & keep)
                        | (uint32_t(st.t0[r][i] == sh) << sl);
                }
                const int sv = st.src[r][i];
                const uint32_t kind = sv == SRC_NONE ? SRC_KIND_NONE
                    : sv == SRC_MANY ? SRC_KIND_MANY : SRC_KIND_ONE;
                kinds = (kinds & ~(3u << 2 * sl)) | (kind << 2 * sl);
                const unsigned long long at = kind == SRC_KIND_ONE
                    ? (unsigned long long)(((lane0 + sv % SNP) & 31)
                                           | (sv / SNP) << 5)
                    : 0ull;
                srcs = (srcs & ~(63ull << 6 * sl)) | (at << 6 * sl);
                open |= bit;
            }
            uint32_t col[W][W], csrc = 0u;
            if constexpr (CLOSE) {
                // bit q % 32 of col[h][q / 32]: the jump q -> s + SNP h is
                // allowed
                csrc = st.csrc[r];
                if (csrc) {
#pragma unroll
                    for (int h = 0; h < W; ++h) {
                        const int sh = s + SNP * h;
#pragma unroll
                        for (int w = 0; w < W; ++w) col[h][w] = 0u;
#pragma unroll
                        for (int q = 0; q < SNP * W; ++q)
                            col[h][q / 32] |=
                                ((st.cmask[r][q][sh / 32] >> (sh % 32)) & 1u)
                                << (q % 32);
                        if (sh >= Sn) {
#pragma unroll
                            for (int w = 0; w < W; ++w) col[h][w] = 0u;
                        }
                    }
                    close_states<WD, SNP, W>(fr, col, lane0);
                }
                ++n_close;
            }
            if (open) {
                const uint32_t lo = __popc(open & 31u), hi = __popc(open >> 5);
                bool run = real;
                for (int rd = 0; rd < R; ++rd) {
                    uint32_t grew = 0u;
#define WGL_PASS(B)                                                       \
    if (open & (1u << B))                                                 \
        pass<WD, SNP, W, B>(fr, grew, dbits, cbits, tbits,                \
                            int((kinds >> 2 * B) & 3u),                   \
                            int((srcs >> 6 * B) & 63u));
                    WGL_PASS(0)
                    WGL_PASS(1)
                    WGL_PASS(2)
                    WGL_PASS(3)
                    WGL_PASS(4)
                    WGL_PASS(5)
                    WGL_PASS(6)
                    WGL_PASS(7)
#undef WGL_PASS
                    // the plane was closed when the round began, so a
                    // lane the passes left unchanged stays closed and
                    // unchanged: only the passes decide, and a round that
                    // changed no lane of the warp needs no closure
                    const uint32_t changed = __ballot_sync(FULL, grew != 0u);
                    if constexpr (CLOSE) {
                        if (csrc && changed)
                            close_states<WD, SNP, W>(fr, col, lane0);
                    }
                    if (run) {
                        n_pass += lo;
                        n_pass5 += hi;
                        n_close += CLOSE;
                    }
                    run = run && (changed & gmask) != 0u;
                    if (!changed) break;    // the warp's lanes are fixed
                }
            }
            const int rs = st.ret[r];
            if (rs >= 0) {
                switch (rs) {
                case 0: retire<WD, W, 0>(fr); break;
                case 1: retire<WD, W, 1>(fr); break;
                case 2: retire<WD, W, 2>(fr); break;
                case 3: retire<WD, W, 3>(fr); break;
                case 4: retire<WD, W, 4>(fr); break;
                case 5: retire<WD, W, 5>(fr); break;
                case 6: retire<WD, W, 6>(fr); break;
                default: retire<WD, W, 7>(fr); break;
                }
                open &= ~(1u << rs);
                n_prune += rs < 5;
                n_prune5 += rs >= 5;
            }
            if (death) {
                uint32_t any = 0u;
#pragma unroll
                for (int h = 0; h < W; ++h)
#pragma unroll
                    for (int w = 0; w < WD; ++w) any |= fr[h][w];
                if (!__any_sync(FULL, any != 0u)) {
                    dead = base + r;    // one warp walks: uniform
                    break;
                }
            }
        }
        if (dead >= 0) break;           // the death row's CTA is one warp
        if (more) store(stage[(c + 1) & 1], base + CHUNK);
        __syncthreads();
    }
    if (__syncthreads_or(refused)) {
        if (tid == 0 && blockIdx.y == 0) atomicAdd(bad, 1);
        return;
    }
    if (death) {
        if (tid == 0) static_cast<int32_t *>(out)[k] = dead;
    } else if (real) {
        uint8_t *o = static_cast<uint8_t *>(out) + ((long long)k * J + j) * J;
#pragma unroll
        for (int h = 0; h < W; ++h) {
            const int sh = s + SNP * h;
            if (sh >= Sn) continue;
            for (int cm = 0; cm < (1 << nc); ++cm) {
                const int m = cm << rn;
                uint32_t word = 0u;
#pragma unroll
                for (int w = 0; w < WD; ++w)
                    word = w == (m >> 5) ? fr[h][w] : word;
                o[cm * Sn + sh] = uint8_t((word >> (m & 31)) & 1u);
            }
        }
    }
    if (work) {
        // every thread of a lane holds its count: take the first row's
        constexpr long long HALF = WD > 1 ? WD / 2 : 1;
        long long v = !real || s ? 0LL
            : (long long)Sn * (n_pass * (long long)(CLOSE_OPS * WD)
                               + n_pass5 * (CLOSE5_OPS * HALF)
                               + n_prune * (long long)(PRUNE_OPS * WD)
                               + n_prune5 * (PRUNE_OPS * HALF))
              + (long long)n_close * CLOSURE_OPS * Sn * Sn * WD;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
        if (lane == 0 && v)
            atomicAdd(reinterpret_cast<unsigned long long *>(work) + k,
                      static_cast<unsigned long long>(v));
    }
}

namespace {

template <int WD, int SNP, bool CLOSE, int W>
void launch_one(dim3 grid, int threads, cudaStream_t stream,
                const void *cbuf, long long nbytes, const void *offs,
                const void *nrows, const void *aux, int UP, const void *ctab,
                int nC, int R, int Sn, int nc, int rn, int J, int LPC,
                int death, unsigned long long seed, void *out, void *work,
                void *bad) {
    wgl_crash_kernel<WD, SNP, CLOSE, W><<<grid, threads, 0, stream>>>(
        (const uint8_t *)cbuf, nbytes, (const int64_t *)offs,
        (const int32_t *)nrows, (const uint32_t *)aux, UP,
        (const uint32_t *)ctab, nC, R, Sn, nc, rn, J, LPC, death, seed, out,
        (long long *)work, (int32_t *)bad);
}

}  // namespace

// Every instance the source builds: (WD, threads a lane, closure, state
// rows a thread); the two-row instances are the relaxed tier's two-word
// lift (33..64 states, the closure only, R <= 6).
#define WGL_CRASH_INSTANCES(X)                                              \
    X(1, 8, false, 1) X(1, 16, false, 1) X(1, 32, false, 1)                 \
    X(2, 8, false, 1) X(2, 16, false, 1) X(2, 32, false, 1)                 \
    X(4, 8, false, 1) X(4, 16, false, 1) X(4, 32, false, 1)                 \
    X(8, 8, false, 1) X(8, 16, false, 1) X(8, 32, false, 1)                 \
    X(1, 8, true, 1) X(1, 16, true, 1) X(1, 32, true, 1) X(2, 8, true, 1)   \
    X(2, 16, true, 1) X(2, 32, true, 1) X(1, 32, true, 2) X(2, 32, true, 2)

// One launch over K segments on `stream`, each segment's J lanes split
// over the fewest CTAs of at most MAXT threads, the lanes spread evenly
// (grid y); returns the cudaError_t of the launch (0 on success).  `work`, when given, must hold K zeros.
// ctab == NULL walks without the state closure (the crash variant, nc >=
// 0); with ctab (nC rows of Sn masks of W words) nc must be 0 and R <= 6,
// and `death` != 0 seeds one lane with `seed` and writes int32 death rows
// instead of u8 transfer rows.  SnP is the state-row bucket (8, 16 or 32
// with one-word masks; 64 with two-word masks, two rows a thread), Sn <=
// SnP the live states.  aux is a1[UP][W] ++ a2[UP][W] ++ t0[UP].
extern "C" int wgl_crash_launch(const void *cbuf, long long nbytes,
                                const void *offs, const void *nrows,
                                const void *aux, int UP, const void *ctab,
                                int nC, int K, int R, int SnP, int Sn, int nc,
                                int rn, int death, unsigned long long seed,
                                void *out, void *work, void *bad,
                                void *stream) {
    if (K <= 0) return 0;
    const bool close = ctab != nullptr;
    const int W = SnP == 64 ? 2 : 1;
    const int tpl = SnP / W;                          // threads a lane
    const int J = death ? 1 : (Sn << nc);
    if (R < 1 || R > MAXR || Sn < 1 || Sn > SnP || nc < 0 || nc > 4 ||
        rn < 0 || rn + nc > R || J > 128 || UP < 1 ||
        (SnP != 8 && SnP != 16 && SnP != 32 && SnP != 64) ||
        (close && (nc != 0 || R > 6 || nC < 1)) || (death && !close) ||
        (W > 1 && !close))
        return (int)cudaErrorInvalidValue;
    const int wd = R <= 5 ? 1 : 1 << (R - 5);
    const int split = (J * tpl + MAXT - 1) / MAXT;   // CTAs a segment
    const int lpc = (J + split - 1) / split;         // lanes a CTA
    const int threads = (lpc * tpl + 31) / 32 * 32;
    const dim3 grid(K, (J + lpc - 1) / lpc);
    cudaStream_t s = (cudaStream_t)stream;
#define WGL_CRASH_CASE(WD, SNP, CL, WW)                                      \
    if (wd == WD && tpl == SNP && close == CL && W == WW)                    \
        launch_one<WD, SNP, CL, WW>(grid, threads, s, cbuf, nbytes, offs,    \
                                    nrows, aux, UP, ctab, nC, R, Sn, nc, rn, \
                                    J, lpc, death, seed, out, work, bad);
    WGL_CRASH_INSTANCES(WGL_CRASH_CASE)
#undef WGL_CRASH_CASE
    return (int)cudaGetLastError();
}
