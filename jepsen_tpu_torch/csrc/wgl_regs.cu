// Register-delta segment scan and its composition, for Hopper (sm_90a).
//
// wgl_regs_kernel replaces jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs
// (:258, an XLA lax.scan, not Pallas) on the path of its nc = 0 callers:
// the composed single-history kernel and the grouped pipeline kernel
// _build_kernel_regs_group_c (:641), whose in-kernel wire unpack
// (_unpack_transfer_bufs, :522) is folded into this kernel's staging.
// It computes, for every lane (segment k, entry state j), the transfer
// row T[k, j, :]: the model states reachable at the segment's end, at
// mask 0, having entered the segment in state j.  wgl_compose_kernel
// replaces the composition those two functions end in (the
// jax.lax.associative_scan at :700 and the composed kernel's at :499):
// each history's chain of transfer matrices, from entry config 0 to the
// first segment that empties it.
//
// State.  A lane's frontier is a bit plane fr[SnP][WD] of 32-bit words:
// state row s, mask word w (WD = max(1, 2^R / 32), so 1 for R <= 5 and
// 2 at R = 6); bit i of word w is the set of linearized open calls
// (w * 32 + i).  Slot b < 5 moves bits inside a word (the _INTRA
// patterns); slot 5 is the word index (word 0 lacks it, word 1 has it).
// The plane starts as the unit config: state j, mask 0.
//
// The walk, per event row (kept exactly from the reference, so the
// transfer matrices are equal bit for bit at any round count):
//   1. register up to I = 2 new invokes: slot b's (a1, a2, t0) words,
//      and the slot opens;
//   2. up to `rounds` closure rounds, Jacobi style: every open slot b
//      adds set_slot(moved_b) computed from the plane as it was at the
//      start of the round, where moved_b = (contrib & diag(a1)) plus, at
//      state t0, the OR over states of (contrib & const(a2)), and
//      contrib is the configs lacking b.  A round that adds nothing
//      leaves the plane as it was, so every later round adds nothing
//      too: the rounds stop there, and the rows equal those of all
//      `rounds` rounds;
//   3. at a return of slot rs, prune the configs lacking rs and clear
//      its bit, and retire the slot.  A virtual row (no return) prunes
//      nothing.
// rounds = R is exact (every config reachable by <= R linearizations is
// in); the pipeline runs fewer, an under-approximation whose deaths the
// host re-checks at rounds = R.
//
// Layout.  One CTA per segment; one thread per (lane j, state row s):
// a lane's SnP rows sit on SnP consecutive threads of one warp (4, 2 or
// 1 lanes a warp at SnP 8, 16 or 32), and the CTA holds ceil(J * SnP /
// 32) warps.  Each thread keeps its row's WD words in registers.  The
// diagonal term and the prune stay inside the thread; the rank-1 term,
// an OR over the lane's state rows, is log2(SnP) __shfl_xor_sync steps
// inside the lane's SnP threads, which the whole warp runs together.
// The CTA stages CHUNK event rows at a time into shared memory, double
// buffered: the next chunk's wire bytes are loaded into registers before
// the walk of this one and stored after it, one __syncthreads a chunk.
// Every decision (which slots are open, the returning slot) is the
// segment's, so no warp diverges; a warp leaves a row's rounds when a
// ballot finds no lane of it changed.
//
// What bounds it on this card: integer operations, and the latency of
// one segment's rows walked as one dependent chain.  A closure pass of a
// slot b < 5 costs six operations per plane word (select the configs
// lacking the slot, the diagonal select, the shift, the OR into the
// round's sum, the rank-1 select, the OR over states), one of slot 5
// four per state row (no lack mask, no shift: word 0 moves to word 1),
// and a prune two per word (the and-not and the shift; at slot 5 the
// move and the clear per state row).  The wire is a few bytes a row,
// and the plane never leaves registers.  One thread per state row keeps
// the integer lanes busy where one thread per lane left 21 of 32 idle
// at J = 11 and walked 16 rows in series; a CTA per segment puts six
// warps on each of the north star's segments, so the card holds many
// chains at once, and the fixpoint stop ends each row after the rounds
// that change something plus one.  The shuffles and ballots are not in
// the count.
//
// Wire.  Segment k's rows lie at byte offs[k] of cbuf in the compact
// layout of ops/wgl_deep.pack_events_compact with L = nrows[k] rows and
// no padding: ret+1 u8[L] ++ islot+1 u8[L * 2] ++ iuop u16-LE [L * 2].
// aux is diag[UP] ++ const[UP] ++ t0[UP] (ops/wgl_deep.pack_aux).  A
// segment whose rows lie outside cbuf, a uop id outside the table or a
// slot at or past R adds one to *bad and writes no transfer row; the
// host reads *bad with the verdicts.
//
// Output: out[K][J][Sn] u8, 1 where state s is reachable at mask 0;
// work[k] (optional) the integer operations of the walk of segment k
// under the costs above, summed over its J lanes: per row, each lane's
// rounds up to the first that leaves its plane unchanged (at most
// `rounds`), each a pass of every open slot over the Sn state rows that
// hold configs (rows Sn..SnP-1 of the plane stay empty and are not
// counted), and a prune at a return.  The per-row mask extraction, the
// landing at t0 and the OR of a round's sum are left out, so the count
// is a floor.
//
// Composition (wgl_compose_kernel).  Only row 0 of the prefix products
// is ever read, so history b's verdict is a chain of one vector through
// its matrices: v = {entry config 0}; at segment k, v <- OR over j in v
// of T[k, j, :]; the first k at which v empties is the dead segment and
// v before it the entry mask.  One CTA per history.  Its 32 warps stage
// a chunk of the history's matrices (as many as COMPOSE_WORDS bits
// hold: a north-star history's 295 matrices of 11 x 11 at once, 33 of
// (c)'s 88 x 88) as a bit map in shared memory, one bit a byte: each
// thread reads 16 aligned bytes at a time, coalesced, folds them to 16
// bits, and pairs of threads write a word.  Then warp 0 walks the
// chain: thread j takes row j (and j + 32, ... up to J <= 128, so v is
// NW <= 4 words) out of the map with a funnel shift where v holds it,
// and one __reduce_or_sync per word gives the next v.  What bounds it:
// T's bytes, read by the one SM that holds the history (about 2.3 MB
// for crash tier 2's J = 88), and the chain of K segments, two shared
// loads and one reduction each.  Output out[B][6] int32: valid, the dead
// segment (-1 if valid), the entry mask's four words (0 when valid).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXR = 6;          // deepest overlap the kernel walks
constexpr int I = 2;             // invoke columns per event row
constexpr int CHUNK = 64;        // event rows staged per step
constexpr int MAXJ = 32;         // entry states per segment
constexpr int MAXJC = 128;       // entry configs of a composed matrix
constexpr int COMPOSE_WARPS = 32;   // warps staging a history's matrices
constexpr int COMPOSE_WORDS = 8192;  // bit-map words staged at once
constexpr int COMPOSE_UNROLL = 4;   // 16-byte loads in flight a thread
constexpr uint32_t FULL = 0xFFFFFFFFu;
// integer operations of the work count (the bound model of the note)
constexpr int CLOSE_OPS = 6;     // per plane word of a slot b < 5 pass
constexpr int CLOSE5_OPS = 4;    // per state row of a slot 5 pass
constexpr int PRUNE_OPS = 2;     // per plane word (state row at slot 5)
// the key kernel (wgl_regs_keys)
constexpr int KEY_CELLS = 128;   // (key, row) cells a warp stages a chunk

// Bit i of intra(b) is set iff mask index i lacks bit b (b < 5).
__host__ __device__ constexpr uint32_t intra(int b) {
    return b == 0 ? 0x55555555u : b == 1 ? 0x33333333u
           : b == 2 ? 0x0F0F0F0Fu : b == 3 ? 0x00FF00FFu : 0x0000FFFFu;
}

// The rank-1 term's sources of a uop, from its const mask a2: none,
// one state (its index), or many.
constexpr int SRC_NONE = -1;
constexpr int SRC_MANY = 32;

struct Stage {
    int32_t ret[CHUNK];
    int32_t slot[CHUNK][I];
    int32_t t0[CHUNK][I];
    int32_t src[CHUNK][I];
    uint32_t a1[CHUNK][I];
    uint32_t a2[CHUNK][I];
};

// OR of v over the SNP consecutive threads of this thread's lane.
template <int SNP>
__device__ __forceinline__ uint32_t or_lane(uint32_t v) {
#pragma unroll
    for (int m = 1; m < SNP; m <<= 1) v |= __shfl_xor_sync(FULL, v, m, SNP);
    return v;
}

// OR of v over this thread's key in the key kernel: its SNP threads.
// With several keys a warp, a shuffle tree under the full mask (a
// reduction under each key's own mask would differ between the keys of
// one warp, which the hardware takes one mask at a time); with one key
// a warp, one reduction.
template <int SNP>
__device__ __forceinline__ uint32_t or_key(uint32_t v) {
    if constexpr (SNP == 32) return __reduce_or_sync(FULL, v);
    else return or_lane<SNP>(v);
}

// The rank-1 term of one plane word x (the configs lacking the slot):
// the OR over the lane's rows s in the slot's a2 (c: this row's bit) of
// their x.  The slot's sources are the CTA's: none, one row (a shuffle
// from lane thread `src`), or many (an OR over the lane's threads).
template <int SNP>
__device__ __forceinline__ uint32_t rank1(uint32_t x, uint32_t cm, int one,
                                          int many, int src) {
    if (one) return __shfl_sync(FULL, x, src);
    if (many) return or_lane<SNP>(x & cm);
    return 0u;
}

// One closure pass of slot B over this thread's state row `fr`, added
// into `add`; dm, tm: all ones where the row is in the slot's a1, and
// is its target state t0; red(x): the rank-1 term of word x (rank1 in
// the segment kernel, one reduction over the key's threads in the key
// kernel).
template <int WD, int B, typename Red>
__device__ __forceinline__ void close_slot(const uint32_t (&fr)[WD],
                                           uint32_t (&add)[WD], uint32_t dm,
                                           uint32_t tm, Red red) {
    if constexpr (B < 5) {
        constexpr uint32_t LACK = intra(B);
        constexpr int SH = 1 << B;
#pragma unroll
        for (int w = 0; w < WD; ++w) {
            const uint32_t x = fr[w] & LACK;
            add[w] |= ((x & dm) | (red(x) & tm)) << SH;
        }
    } else if constexpr (WD == 2) {
        // slot 5: word 0 lacks it; linearizing moves word 0 to word 1
        const uint32_t x = fr[0];
        add[1] |= (x & dm) | (red(x) & tm);
    }
}

// Register an invoke on slot sl (0 <= sl < MAXR; -1: none, a no-op)
// for this thread's state row s: its uop's a1 and a2 masks and target
// state t0 into the slot registers, and the slot opens.
__device__ __forceinline__ void note_slot(int sl, int s, uint32_t a1,
                                          uint32_t a2, int t0,
                                          uint32_t (&dmk)[MAXR],
                                          uint32_t (&cmk)[MAXR],
                                          uint32_t &tsel, uint32_t &open) {
    const uint32_t bit = sl >= 0 ? 1u << (sl & 31) : 0u;
    const uint32_t dm = 0u - ((a1 >> s) & 1u);
    const uint32_t cm = 0u - ((a2 >> s) & 1u);
#pragma unroll
    for (int b = 0; b < MAXR; ++b) {
        if (sl == b) {
            dmk[b] = dm;
            cmk[b] = cm;
        }
    }
    tsel = (tsel & ~bit) | (t0 == s ? bit : 0u);
    open |= bit;
}

// Prune the configs lacking slot B and clear its bit.
template <int WD, int B>
__device__ __forceinline__ void retire_slot(uint32_t (&fr)[WD]) {
    if constexpr (B < 5) {
#pragma unroll
        for (int w = 0; w < WD; ++w)
            fr[w] = (fr[w] & ~intra(B)) >> (1 << B);
    } else if constexpr (WD == 2) {
        fr[0] = fr[1];
        fr[1] = 0u;
    }
}

// Retire slot B where rs is B, with selects and no branch (the keys of
// a warp return different slots).
template <int WD, int B>
__device__ __forceinline__ void retire_if(uint32_t (&fr)[WD], int rs) {
    uint32_t t[WD];
#pragma unroll
    for (int w = 0; w < WD; ++w) t[w] = fr[w];
    retire_slot<WD, B>(t);
#pragma unroll
    for (int w = 0; w < WD; ++w) fr[w] = rs == B ? t[w] : fr[w];
}

// The return of slot rs (-1: none) on this thread's row: prune and
// retire it, close the slot, and count the prune (b < 5 or b = 5).  The
// segment kernel's rs is the CTA's and switches; the key kernel's
// (SELECT) is each key's and selects.
template <int WD, bool SELECT = false>
__device__ __forceinline__ void retire(uint32_t (&fr)[WD], int rs,
                                       uint32_t &open, uint32_t &n_prune,
                                       uint32_t &n_prune5) {
    if constexpr (SELECT) {
        retire_if<WD, 0>(fr, rs);
        retire_if<WD, 1>(fr, rs);
        retire_if<WD, 2>(fr, rs);
        retire_if<WD, 3>(fr, rs);
        retire_if<WD, 4>(fr, rs);
        retire_if<WD, 5>(fr, rs);
    } else if (rs >= 0) {
        switch (rs) {
        case 0: retire_slot<WD, 0>(fr); break;
        case 1: retire_slot<WD, 1>(fr); break;
        case 2: retire_slot<WD, 2>(fr); break;
        case 3: retire_slot<WD, 3>(fr); break;
        case 4: retire_slot<WD, 4>(fr); break;
        default: retire_slot<WD, 5>(fr); break;
        }
    }
    open &= ~(uint32_t(rs >= 0) << (rs & 31));
    n_prune += rs >= 0 && rs < 5;
    n_prune5 += rs == 5;
}

// A lane's work count from its passes and prunes (the bound model).
template <int WD>
__device__ __forceinline__ long long walk_ops(int Sn, uint32_t n_pass,
                                              uint32_t n_pass5,
                                              uint32_t n_prune,
                                              uint32_t n_prune5) {
    return (long long)Sn * (n_pass * (long long)(CLOSE_OPS * WD)
                            + n_pass5 * (long long)CLOSE5_OPS
                            + n_prune * (long long)(PRUNE_OPS * WD)
                            + n_prune5 * (long long)PRUNE_OPS);
}

}  // namespace

template <int WD, int SNP>
__global__ void __launch_bounds__(MAXJ * SNP)
wgl_regs_kernel(const uint8_t *__restrict__ cbuf, long long nbytes,
                const int64_t *__restrict__ offs,
                const int32_t *__restrict__ nrows,
                const uint32_t *__restrict__ aux, int UP, int K, int R,
                int J, int Sn, int rounds, uint8_t *__restrict__ out,
                long long *__restrict__ work, int32_t *__restrict__ bad) {
    __shared__ Stage stage[2];
    __shared__ long long warp_ops[MAXJ];
    constexpr int CELLS = CHUNK * I;
    constexpr int CPT = CELLS / 32;     // staged cells a thread, at most
    constexpr int RPT = CHUNK / 32;     // staged returns a thread, at most
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31;
    const int j = tid / SNP;            // the lane's entry state
    const int s = tid % SNP;            // this thread's state row
    const uint32_t gmask =
        SNP == 32 ? FULL : ((1u << (SNP & 31)) - 1u) << (lane & ~(SNP - 1));
    const bool real = j < J;
    const int k = blockIdx.x;
    const long long off = offs[k];
    const int L = nrows[k];
    if (L < 0 || off < 0 || off + 7LL * L > nbytes) {
        if (tid == 0) atomicAdd(bad, 1);
        return;                         // the whole CTA leaves together
    }
    const uint8_t *ret_b = cbuf + off;
    const uint8_t *isl_b = ret_b + L;
    const uint8_t *iu_b = ret_b + 3LL * L;
    int refused = 0;                    // this thread staged a bad cell

    // the next chunk's wire bytes, loaded before a walk, stored after it
    int p_ret[RPT], p_sl[CPT], p_u[CPT];
    auto fetch = [&](int base) {
        const int n = min(CHUNK, L - base);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
            const int r = tid + q * nt;
            p_ret[q] = r < n ? int(ret_b[base + r]) - 1 : -1;
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
            const int x = tid + q * nt;
            if (x < n * I) {
                const long long c = (long long)base * I + x;
                p_sl[q] = int(isl_b[c]) - 1;
                p_u[q] = int(iu_b[2 * c]) | (int(iu_b[2 * c + 1]) << 8);
            } else {
                p_sl[q] = -1;
                p_u[q] = 0;
            }
        }
    };
    auto store = [&](Stage &st, int base) {
        const int n = min(CHUNK, L - base);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
            const int r = tid + q * nt;
            if (r < n) {
                int rs = p_ret[q];
                if (rs >= R) {
                    refused = 1;
                    rs = -1;
                }
                st.ret[r] = rs;
            }
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
            const int x = tid + q * nt;
            if (x < n * I) {
                int sl = p_sl[q];
                const int u = p_u[q];
                if (sl >= 0 && (u >= UP || sl >= R)) {
                    refused = 1;
                    sl = -1;
                }
                st.slot[x / I][x % I] = sl;
                if (sl >= 0) {
                    const uint32_t a2 = aux[UP + u];
                    st.a1[x / I][x % I] = aux[u];
                    st.a2[x / I][x % I] = a2;
                    st.t0[x / I][x % I] = int(aux[2 * UP + u]);
                    st.src[x / I][x % I] = a2 == 0u ? SRC_NONE
                        : (a2 & (a2 - 1u)) ? SRC_MANY : __ffs(a2) - 1;
                }
            }
        }
    };

    uint32_t fr[WD];
#pragma unroll
    for (int w = 0; w < WD; ++w) fr[w] = (w == 0 && real && s == j) ? 1u : 0u;
    // dmk[b] / cmk[b]: all ones where this row is in slot b's a1 / a2;
    // bit b of tsel: this row is slot b's t0; bit b of one / many: slot
    // b's rank-1 term has one source row (5-bit field b of srcs) or many
    uint32_t dmk[MAXR], cmk[MAXR];
#pragma unroll
    for (int b = 0; b < MAXR; ++b) dmk[b] = cmk[b] = 0u;
    uint32_t tsel = 0u, one = 0u, many = 0u, srcs = 0u;
    const int lane0 = lane & ~(SNP - 1);    // the lane's first thread
    uint32_t open = 0u;                 // bit b: slot b is open
    // this thread's lane's passes and prunes at slots b < 5 and b = 5,
    // the terms of its work count
    uint32_t n_pass = 0u, n_pass5 = 0u, n_prune = 0u, n_prune5 = 0u;

    if (L > 0) {
        fetch(0);
        store(stage[0], 0);
    }
    __syncthreads();
    for (int base = 0, c = 0; base < L; base += CHUNK, ++c) {
        const int n = min(CHUNK, L - base);
        const bool more = base + CHUNK < L;
        if (more) fetch(base + CHUNK);
        const Stage &st = stage[c & 1];
        for (int r = 0; r < n; ++r) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = st.slot[r][i];
                if (sl < 0) continue;
                note_slot(sl, s, st.a1[r][i], st.a2[r][i], st.t0[r][i],
                          dmk, cmk, tsel, open);
                const uint32_t bit = 1u << sl;
                const int sv = st.src[r][i];
                one = (one & ~bit) | (sv >= 0 && sv < SRC_MANY ? bit : 0u);
                many = (many & ~bit) | (sv == SRC_MANY ? bit : 0u);
                srcs = (srcs & ~(31u << 5 * sl))
                       | (uint32_t(sv & 31) << 5 * sl);
            }
            if (open) {
                const uint32_t lo = __popc(open & 31u), hi = open >> 5;
                bool run = real;
                for (int rd = 0; rd < rounds; ++rd) {
                    uint32_t add[WD];
#pragma unroll
                    for (int w = 0; w < WD; ++w) add[w] = 0u;
#define WGL_CLOSE(B)                                                      \
    if (open & (1u << B))                                                 \
        close_slot<WD, B>(fr, add, dmk[B], 0u - ((tsel >> B) & 1u),       \
                          [&](uint32_t x) {                               \
                              return rank1<SNP>(                          \
                                  x, cmk[B], (one >> B) & 1u,             \
                                  (many >> B) & 1u,                       \
                                  lane0 + int((srcs >> 5 * B) & 31u));    \
                          });
                    WGL_CLOSE(0)
                    WGL_CLOSE(1)
                    WGL_CLOSE(2)
                    WGL_CLOSE(3)
                    WGL_CLOSE(4)
                    WGL_CLOSE(5)
#undef WGL_CLOSE
                    uint32_t grew = 0u;
#pragma unroll
                    for (int w = 0; w < WD; ++w) {
                        grew |= add[w] & ~fr[w];
                        fr[w] |= add[w];
                    }
                    const uint32_t changed = __ballot_sync(FULL, grew != 0u);
                    if (run) {
                        n_pass += lo;
                        n_pass5 += hi;
                    }
                    run = run && (changed & gmask) != 0u;
                    if (!changed) break;    // the warp's lanes are fixed
                }
            }
            retire(fr, st.ret[r], open, n_prune, n_prune5);
        }
        if (more) store(stage[(c + 1) & 1], base + CHUNK);
        __syncthreads();
    }
    if (__syncthreads_or(refused)) {
        if (tid == 0) atomicAdd(bad, 1);
        return;
    }
    if (real && s < Sn)
        out[((long long)k * J + j) * Sn + s] = uint8_t(fr[0] & 1u);
    if (work) {
        // every thread of a lane holds its count: take the first row's
        long long v = !real || s ? 0LL
            : walk_ops<WD>(Sn, n_pass, n_pass5, n_prune, n_prune5);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
        if (lane == 0) warp_ops[tid >> 5] = v;
        __syncthreads();
        if (tid == 0) {
            long long sum = 0;
            for (int w = 0; w < (nt >> 5); ++w) sum += warp_ops[w];
            work[k] = sum;
        }
    }
}

// The key kernel (wgl_regs_keys) replaces
// jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs_many_c (:725, the XLA
// scan at J = 1 behind an unpack of the key-major wire): per key, one
// lane entering state 0 walks the key's whole wire (one segment a key,
// the layout above) at exact rounds R; out[K][Sn] u8 (the [K, 1, Sn]
// transfer rows), 1 where state s survives the key's last row.  The
// walk, the costs of work[k] and the refusals are the segment kernel's
// at J = 1; a refused key adds one to *bad and writes neither its row
// nor its count, and its warp-mates finish.
//
// Layout.  G = 32 / SnP keys a warp (4, 2, 1 at SnP 8, 16, 32), one
// thread per (key g, state row s), W = blockDim.x / 32 warps a CTA, each
// with its own keys and its own slice of the staging; the launch gives
// one warp a CTA (1, 2, 4 and 8 measured within 4% of each other).  The
// body stays written for W warps, bound at 256 threads: the same body
// for one warp (constant shared addresses, 32 threads) compiled to a
// schedule that measured 35% slower on the H100 (PERF.md).  The segment
// kernel at J = 1 put one key on a warp and left 32 - SnP of its threads
// walking empty planes.  A warp's keys walk row r together, so the warp
// runs as long as its longest key (the host orders the keys longest
// first), and a key past its own last row stands still.  The control
// flow is the warp's and the decisions are each key's data: every slot's
// pass runs in every round, without a branch, masked to nothing where
// the key has the slot closed; the rank-1 term is an OR over the key's
// SnP threads whatever the slot's sources (a shuffle tree under the full
// mask, one reduction when a key fills the warp); the return retires
// with selects; the rounds end when a ballot finds no key of the warp
// changed, or after as many rounds as the most open slots of a key (a
// config takes one linearization a round and one a slot, so no later
// round adds one), each key's count stopping at its own fixpoint.
// Each warp stages its keys' next KEY_CELLS (key, row) cells alone,
// with __syncwarp and no CTA barrier: the wire bytes in registers
// before the walk of a chunk, and after it, the invokes' uops looked
// up in the table (L1), each cell as its two invokes' a1 and a2 words
// and one packed word (return, slots, targets) in shared memory.  Rows
// past a key's end stage empty.  A row's walk reads its cell (read
// during the row before), registers, and runs its rounds.
//
// What bounds it: integer operations, as the segment kernel's, and the
// chain of a key's rows.  Measured on an H100 (PERF.md): the J = 1
// launch cost 1565 cycles a row for one key's chain alone and 2324 at
// 3400 keys; most of a row is its rounds, and most of a round the
// shuffle trees of the five slots' rank-1 terms, issued together.  Two
// ways to run fewer of them measured slower: a branch per slot and
// source kind (one row: one shuffle; all rows: one tree for all such
// slots), which waits for each slot's shuffles in turn, and the same
// without branches for tables without other kinds, which spilled.
template <int WD, int SNP>
__global__ void __launch_bounds__(256)
wgl_regs_keys(const uint8_t *__restrict__ cbuf, long long nbytes,
              const int64_t *__restrict__ offs,
              const int32_t *__restrict__ nrows,
              const uint32_t *__restrict__ aux, int UP, int K, int R,
              int Sn, uint8_t *__restrict__ out,
              long long *__restrict__ work, int32_t *__restrict__ bad) {
    constexpr int G = 32 / SNP;         // keys a warp
    constexpr int CH = KEY_CELLS / G;   // rows of a key a chunk
    constexpr int Q = KEY_CELLS / 32;   // cells a thread stages
    // a warp's two chunks of staged cells: [W][2][CH][G] uint4 (the two
    // invokes' a1 and a2 words), then [W][2][CH][G] packed words
    extern __shared__ uint4 key_smem[];
    const int tid = threadIdx.x, lane = tid & 31, W = blockDim.x >> 5;
    uint4 *const stm = key_smem + (tid >> 5) * 2 * KEY_CELLS;
    uint32_t *const stp = reinterpret_cast<uint32_t *>(
        key_smem + W * 2 * KEY_CELLS) + (tid >> 5) * 2 * KEY_CELLS;
    const int g = lane / SNP;           // the warp's key
    const int s = lane % SNP;           // this thread's state row
    const uint32_t gmask =
        SNP == 32 ? FULL : ((1u << (SNP & 31)) - 1u) << (lane & ~(SNP - 1));
    const long long k =
        ((long long)blockIdx.x * W + (tid >> 5)) * G + g;
    const bool real = k < K;
    long long off = real ? offs[k] : 0;
    int L = real ? nrows[k] : 0;
    uint32_t badk = 0u;                 // bit g: this thread refused key g
    if (L < 0 || off < 0 || off + 7LL * L > nbytes) {
        badk = 1u << g;
        L = 0;
        off = 0;
    }
    const int Lw = __reduce_max_sync(FULL, L);
    const unsigned long long kb = (unsigned long long)(cbuf + off);

    // the next chunk's wire bytes: cell x = lane + 32 q is key x / CH's
    // row x % CH of the chunk (ret+1 | slot+1 << 8 | slot+1 << 16, and
    // the two uop ids)
    uint2 pf[Q];
    auto fetch = [&](int base) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int gq = q * 32 / CH;
            const long long r = base + (lane + 32 * q) % CH;
            const int Lq = __shfl_sync(FULL, L, gq * SNP);
            const uint8_t *b =
                (const uint8_t *)__shfl_sync(FULL, kb, gq * SNP);
            uint32_t x = 0u, y = 0u;
            if (r < Lq) {
                const uint8_t *sl = b + Lq + 2 * r;
                const uint8_t *u = b + 3LL * Lq + 4 * r;
                x = uint32_t(b[r]) | uint32_t(sl[0]) << 8
                    | uint32_t(sl[1]) << 16;
                y = uint32_t(u[0]) | uint32_t(u[1]) << 8
                    | uint32_t(u[2]) << 16 | uint32_t(u[3]) << 24;
            }
            pf[q] = make_uint2(x, y);
        }
    };
    // validate them (a slot or return at or past R, or a uop id outside
    // the table, refuses the key and stages empty), look the invokes'
    // uops up in the table, and store each cell as its a1 / a2 words
    // and one packed word: ret+1 (bits 0..2), each invoke's slot+1
    // (3..5, 6..8) and target state t0 (16..21, 24..29; 32 for none)
    auto store = [&](uint4 *bm, uint32_t *bp) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int gq = q * 32 / CH;
            const int x = ((lane + 32 * q) % CH) * G + gq;
            int rs = int(pf[q].x & 255u) - 1;
            if (rs >= R) {
                badk |= 1u << gq;
                rs = -1;
            }
            uint32_t pk = uint32_t(rs + 1), a[2 * I] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = int((pf[q].x >> (8 + 8 * i)) & 255u) - 1;
                const uint32_t u = (pf[q].y >> 16 * i) & 0xFFFFu;
                if (sl < 0) continue;
                if (u >= uint32_t(UP) || sl >= R) {
                    badk |= 1u << gq;
                    continue;
                }
                a[2 * i] = __ldg(aux + u);
                a[2 * i + 1] = __ldg(aux + UP + u);
                pk |= uint32_t(sl + 1) << (3 + 3 * i)
                    | min(__ldg(aux + 2 * UP + u), 32u) << (16 + 8 * i);
            }
            bm[x] = make_uint4(a[0], a[1], a[2], a[3]);
            bp[x] = pk;
        }
    };

    uint32_t fr[WD];
#pragma unroll
    for (int w = 0; w < WD; ++w) fr[w] = (w == 0 && real && s == 0) ? 1u : 0u;
    // the slot registers of the segment kernel, each key's own
    uint32_t dmk[MAXR], cmk[MAXR];
#pragma unroll
    for (int b = 0; b < MAXR; ++b) dmk[b] = cmk[b] = 0u;
    uint32_t tsel = 0u, open = 0u;
    uint32_t n_pass = 0u, n_pass5 = 0u, n_prune = 0u, n_prune5 = 0u;

    if (Lw > 0) {
        fetch(0);
        store(stm, stp);
    }
    __syncwarp();
    for (int base = 0, c = 0; base < Lw; base += CH, ++c) {
        const int n = min(CH, Lw - base);
        const bool more = base + CH < Lw;
        if (more) fetch(base + CH);
        const uint4 *bm = stm + (c & 1) * KEY_CELLS;
        const uint32_t *bp = stp + (c & 1) * KEY_CELLS;
        uint4 m = bm[g];
        uint32_t pk = bp[g];
        for (int r = 0; r < n; ++r) {
            // the next row's cell, read while this one walks
            const int nx = (r + 1 < n ? r + 1 : r) * G + g;
            const uint4 m1 = bm[nx];
            const uint32_t pk1 = bp[nx];
#pragma unroll
            for (int i = 0; i < I; ++i)
                note_slot(int((pk >> (3 + 3 * i)) & 7u) - 1, s,
                          i ? m.z : m.x, i ? m.w : m.y,
                          int((pk >> (16 + 8 * i)) & 63u), dmk, cmk, tsel,
                          open);
            // the key's open slots at a row it holds, and each slot's
            // masks, zero where the slot is not open
            const uint32_t kopen = base + r < L ? open : 0u;
            uint32_t dm[MAXR], tm[MAXR];
#pragma unroll
            for (int b = 0; b < MAXR; ++b) {
                const uint32_t on = 0u - ((kopen >> b) & 1u);
                dm[b] = dmk[b] & on;
                tm[b] = (0u - ((tsel >> b) & 1u)) & on;
            }
            const int nopen = __popc(kopen);
            const uint32_t lo = __popc(kopen & 31u), hi = kopen >> 5;
            // a config takes at most one linearization a round and one a
            // slot, so no round after the nopen-th adds a config: the
            // warp stops there (the plain version runs one more round,
            // which changes nothing, and counts it: so does `run` below)
            const int rounds = min(R, __reduce_max_sync(FULL, nopen));
            bool run = kopen != 0u;
            for (int rd = 0; rd < rounds; ++rd) {
                uint32_t add[WD];
#pragma unroll
                for (int w = 0; w < WD; ++w) add[w] = 0u;
                // every slot's pass, without a branch, so that their
                // shuffle trees are in flight together; a closed slot's
                // masks add nothing
#define WGL_CLOSE_KEYS(B)                                                 \
    close_slot<WD, B>(fr, add, dm[B], tm[B],                              \
                      [&](uint32_t x) { return or_key<SNP>(x & cmk[B]); });
                WGL_CLOSE_KEYS(0)
                WGL_CLOSE_KEYS(1)
                WGL_CLOSE_KEYS(2)
                WGL_CLOSE_KEYS(3)
                WGL_CLOSE_KEYS(4)
                WGL_CLOSE_KEYS(5)
#undef WGL_CLOSE_KEYS
                uint32_t grew = 0u;
#pragma unroll
                for (int w = 0; w < WD; ++w) {
                    grew |= add[w] & ~fr[w];
                    fr[w] |= add[w];
                }
                const uint32_t changed = __ballot_sync(FULL, grew != 0u);
                if (run) {
                    n_pass += lo;
                    n_pass5 += hi;
                }
                run = run && (changed & gmask) != 0u;
                if (!changed) break;    // every key of the warp fixed
            }
            // a key that changed in its last round, below R rounds: the
            // plain version's next round, which adds nothing
            if (run && nopen < R) {
                n_pass += lo;
                n_pass5 += hi;
            }
            retire<WD, true>(fr, int(pk & 7u) - 1, open, n_prune,
                             n_prune5);
            m = m1;
            pk = pk1;
        }
        if (more)
            store(stm + ((c + 1) & 1) * KEY_CELLS,
                  stp + ((c + 1) & 1) * KEY_CELLS);
        __syncwarp();
    }
    const uint32_t refused = __reduce_or_sync(FULL, badk);
    if (lane == 0 && refused) atomicAdd(bad, __popc(refused));
    if (!real || ((refused >> g) & 1u)) return;
    if (s < Sn) out[k * Sn + s] = uint8_t(fr[0] & 1u);
    if (work && s == 0)
        work[k] = walk_ops<WD>(Sn, n_pass, n_pass5, n_prune, n_prune5);
}

// Bits q of the result: byte q of x is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;
    return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

template <int NW>
__global__ void __launch_bounds__(32 * COMPOSE_WARPS)
wgl_compose_kernel(const uint8_t *__restrict__ T, int J,
                   const int64_t *__restrict__ first,
                   const int32_t *__restrict__ count,
                   int32_t *__restrict__ out) {
    // bit i of the map: the byte i of the staged span, which starts at
    // the 16-byte boundary at or before the chunk's first byte (s bytes
    // before it), is nonzero; the word past the span pads the walk's
    // funnel shift
    __shared__ uint32_t bits[COMPOSE_WORDS + 1];
    __shared__ int died_at;
    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31;
    const long long JJ = (long long)J * J;
    const int K = count[b];
    const int per = (int)(32LL * (COMPOSE_WORDS - 2) / JJ);  // a chunk
    const uint8_t *hist = T + first[b] * JJ;
    uint32_t v[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) v[w] = w == 0 ? 1u : 0u;
    int dead = -1;
    if (tid == 0) died_at = -1;
    for (int k0 = 0; k0 < K; k0 += per) {
        __syncthreads();                // died_at, and the last walk done
        if (died_at >= 0) break;
        const int n = min(per, K - k0);
        const uint8_t *base = hist + (long long)k0 * JJ;
        const uintptr_t a0 = (uintptr_t)base & ~(uintptr_t)15;
        const int s = (int)((uintptr_t)base - a0);
        const int nblk = (int)((s + n * JJ + 15) >> 4);
        const uint4 *src = (const uint4 *)a0;
        // 16-byte block i to bits 16 i .. 16 i + 15; the whole warp runs
        // each step together (its blocks are 32 consecutive ones).  The
        // blocks at the span's two ends may hold up to 15 bytes outside
        // the chunk: they lie in T's allocation (the caching allocator
        // hands out 512-byte multiples), and the walk never reads them
        for (int i0 = tid - lane; i0 < nblk;
             i0 += COMPOSE_UNROLL * blockDim.x) {
            uint4 x[COMPOSE_UNROLL];
#pragma unroll
            for (int u = 0; u < COMPOSE_UNROLL; ++u) {
                const int i = i0 + u * blockDim.x + lane;
                x[u] = i < nblk ? __ldg(src + i) : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < COMPOSE_UNROLL; ++u) {
                const int i = i0 + u * blockDim.x + lane;
                uint32_t h = nonzero_bytes(x[u].x) |
                             nonzero_bytes(x[u].y) << 4 |
                             nonzero_bytes(x[u].z) << 8 |
                             nonzero_bytes(x[u].w) << 12;
                h <<= 16 * (lane & 1);
                h |= __shfl_xor_sync(FULL, h, 1);
                if (!(lane & 1) && i < nblk) bits[i >> 1] = h;
            }
        }
        __syncthreads();
        if (tid >= 32) continue;        // one warp walks the chain
        for (int k = 0; k < n; ++k) {
            // thread `lane` ORs in its rows lane + 32 q that v holds
            uint32_t acc[NW];
#pragma unroll
            for (int w = 0; w < NW; ++w) acc[w] = 0u;
#pragma unroll
            for (int q = 0; q < NW; ++q) {
                const int j = lane + 32 * q;
                if (j < J && ((v[q] >> lane) & 1u)) {
                    const int row = s + (k * J + j) * J;
#pragma unroll
                    for (int w = 0; w < NW; ++w) {
                        const int off = row + 32 * w;
                        const int len = min(32, J - 32 * w);
                        const uint32_t x = __funnelshift_r(
                            bits[off >> 5], bits[(off >> 5) + 1], off & 31);
                        acc[w] |= len == 32 ? x : x & ((1u << len) - 1u);
                    }
                }
            }
            uint32_t any = 0u, nv[NW];
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                nv[w] = __reduce_or_sync(FULL, acc[w]);
                any |= nv[w];
            }
            if (!any) {                 // v, before it, is the entry mask
                dead = k0 + k;
                if (lane == 0) died_at = dead;
                break;
            }
#pragma unroll
            for (int w = 0; w < NW; ++w) v[w] = nv[w];
        }
    }
    if (tid < 6) {                      // warp 0 holds the verdict
        int32_t x = dead < 0 ? 1 : 0;
        if (tid == 1) x = dead;
        if (tid >= 2) {
            uint32_t word = 0u;
#pragma unroll
            for (int w = 0; w < NW; ++w) word = tid - 2 == w ? v[w] : word;
            x = dead < 0 ? 0 : int32_t(word);
        }
        out[b * 6 + tid] = x;
    }
}

namespace {

template <int WD, int SNP>
void launch_one(int K, int threads, cudaStream_t stream, const void *cbuf,
                long long nbytes, const void *offs, const void *nrows,
                const void *aux, int UP, int R, int J, int Sn, int rounds,
                void *out, void *work, void *bad) {
    wgl_regs_kernel<WD, SNP><<<K, threads, 0, stream>>>(
        (const uint8_t *)cbuf, nbytes, (const int64_t *)offs,
        (const int32_t *)nrows, (const uint32_t *)aux, UP, K, R, J, Sn,
        rounds, (uint8_t *)out, (long long *)work, (int32_t *)bad);
}

}  // namespace

// One launch over K segments on `stream`, one CTA a segment; returns the
// cudaError_t of the launch (0 on success).  R sizes the plane (WD = 2
// at R = 6), SnP is the state-row bucket (8, 16 or 32) and Sn <= SnP
// the states written.
extern "C" int wgl_regs_launch(const void *cbuf, long long nbytes,
                               const void *offs, const void *nrows,
                               const void *aux, int UP, int K, int R,
                               int SnP, int Sn, int J, int rounds, void *out,
                               void *work, void *bad, void *stream) {
    if (K <= 0) return 0;
    if (R < 1 || R > MAXR || J < 1 || J > MAXJ || Sn < 1 || Sn > SnP ||
        rounds < 1 || UP < 1 || (SnP != 8 && SnP != 16 && SnP != 32))
        return (int)cudaErrorInvalidValue;
    const int threads = (J * SnP + 31) / 32 * 32;
    cudaStream_t s = (cudaStream_t)stream;
    const int wd = R <= 5 ? 1 : 2;
#define WGL_REGS_CASE(WD, SNP)                                             \
    if (wd == WD && SnP == SNP)                                            \
        launch_one<WD, SNP>(K, threads, s, cbuf, nbytes, offs, nrows, aux, \
                            UP, R, J, Sn, rounds, out, work, bad);
    WGL_REGS_CASE(1, 8)
    WGL_REGS_CASE(1, 16)
    WGL_REGS_CASE(1, 32)
    WGL_REGS_CASE(2, 8)
    WGL_REGS_CASE(2, 16)
    WGL_REGS_CASE(2, 32)
#undef WGL_REGS_CASE
    return (int)cudaGetLastError();
}

namespace {

template <int WD, int SNP>
void launch_keys(int grid, cudaStream_t stream, const void *cbuf,
                 long long nbytes, const void *offs, const void *nrows,
                 const void *aux, int UP, int K, int R, int Sn, void *out,
                 void *work, void *bad) {
    // one warp: its two chunks of staged cells, 16 + 4 bytes a cell
    constexpr size_t smem = (sizeof(uint4) + sizeof(uint32_t)) * 2 * KEY_CELLS;
    wgl_regs_keys<WD, SNP><<<grid, 32, smem, stream>>>(
        (const uint8_t *)cbuf, nbytes, (const int64_t *)offs,
        (const int32_t *)nrows, (const uint32_t *)aux, UP, K, R, Sn,
        (uint8_t *)out, (long long *)work, (int32_t *)bad);
}

}  // namespace

// The key launch over K keys on `stream`: G = 32 / SnP keys a warp,
// one warp a CTA, exact rounds R; returns the cudaError_t of the launch
// (0 on success).  R sizes the plane (WD = 2 at R = 6), SnP is the
// state-row bucket (8, 16 or 32) and Sn <= SnP the states written.
extern "C" int wgl_keys_launch(const void *cbuf, long long nbytes,
                               const void *offs, const void *nrows,
                               const void *aux, int UP, int K, int R,
                               int SnP, int Sn, void *out, void *work,
                               void *bad, void *stream) {
    if (K <= 0) return 0;
    if (R < 1 || R > MAXR || Sn < 1 || Sn > SnP || UP < 1 ||
        (SnP != 8 && SnP != 16 && SnP != 32))
        return (int)cudaErrorInvalidValue;
    const int per = 32 / SnP;               // keys a CTA
    const int grid = (K + per - 1) / per;
    cudaStream_t s = (cudaStream_t)stream;
    const int wd = R <= 5 ? 1 : 2;
#define WGL_KEYS_CASE(WD, SNP)                                             \
    if (wd == WD && SnP == SNP)                                            \
        launch_keys<WD, SNP>(grid, s, cbuf, nbytes, offs, nrows, aux, UP, \
                             K, R, Sn, out, work, bad);
    WGL_KEYS_CASE(1, 8)
    WGL_KEYS_CASE(1, 16)
    WGL_KEYS_CASE(1, 32)
    WGL_KEYS_CASE(2, 8)
    WGL_KEYS_CASE(2, 16)
    WGL_KEYS_CASE(2, 32)
#undef WGL_KEYS_CASE
    return (int)cudaGetLastError();
}

// The verdict words of B histories, one CTA each, on `stream`: history
// b's count[b] >= 1 transfer matrices T[first[b] + k] (u8 [J][J], J <=
// 128).  Returns the cudaError_t of the launch.
extern "C" int wgl_compose_launch(const void *T, int J, const void *first,
                                  const void *count, int B, void *out,
                                  void *stream) {
    if (B <= 0) return 0;
    if (J < 1 || J > MAXJC) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int nw = (J + 31) / 32;
#define WGL_COMPOSE_CASE(NW)                                               \
    if (nw == NW)                                                          \
        wgl_compose_kernel<NW><<<B, 32 * COMPOSE_WARPS, 0, s>>>(           \
            (const uint8_t *)T, J, (const int64_t *)first,                 \
            (const int32_t *)count, (int32_t *)out);
    WGL_COMPOSE_CASE(1)
    WGL_COMPOSE_CASE(2)
    WGL_COMPOSE_CASE(3)
    WGL_COMPOSE_CASE(4)
#undef WGL_COMPOSE_CASE
    return (int)cudaGetLastError();
}
