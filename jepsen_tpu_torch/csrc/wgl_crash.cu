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
// open slot b (the configs lacking b: moved = contrib & diag(a1), and at
// state t0 the OR over states of contrib & const(a2), set into b) [then
// close the states]; at a return of slot rs, prune the configs lacking rs
// and clear its bit, and retire the slot.  R rounds reach the fixpoint,
// so each pass updates the plane in place (Gauss-Seidel): a round then
// holds at least what the reference's Jacobi round holds and no more than
// the fixpoint, and the transfer rows are the same bit for bit.  Inside
// one pass the update is the Jacobi one, since a pass only sets bits its
// sources lack.  A round only sets bits, so a lane changed iff its plane's
// popcount grew; a warp leaves the row's rounds when a ballot finds no
// lane changed (a lane that did not change is at its fixpoint and stays
// there).
//
// Layout.  One thread per (lane, word column): thread g of a segment owns
// word w = g % WD of every state row of lane j = g / WD, SnP registers.
// A slot b < 5 pass, a prune and the state closure stay inside the
// thread; a slot b >= 5 pass and its prune read the partner column
// w ^ (1 << (b - 5)) with one shuffle per state row (the WD threads of a
// lane are consecutive lanes of one warp).  A segment spans
// ceil(J * WD / 128) blocks of at most 128 threads (grid y); every block
// of a segment stages the same rows, CHUNK at a time, into shared memory
// (ret, slots, the slots' table words and, with the closure, the row's
// ctab masks) between two barriers, and every decision in the walk is the
// segment's, so no warp diverges.  Warps past J * WD lanes stage and wait
// at the barriers but do not walk.
//
// The work= count, the integer operations the walk needs: a lane's plane
// is at most 32 words per thread, in registers; the wire is 7 (9 with the
// closure) bytes a row.  Per row and lane it charges a pass of slot b < 5
// CLOSE_OPS per word of the Sn live state rows, of slot b >= 5 CLOSE5_OPS
// per state row of each receiving word (WD / 2), a prune PRUNE_OPS per
// word (per state row and receiving word at b >= 5), a state closure
// CLOSURE_OPS per (source, target) pair and word; and each round the lane
// runs up to the first that leaves its plane unchanged (at most R), not
// the rounds its warp runs on for other lanes.  Each lane adds its count
// to work[k], which the caller zeroes.
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
constexpr int CHUNK = 64;        // event rows staged per step
constexpr int THREADS = 128;     // threads per block at most
constexpr unsigned FULL = 0xFFFFFFFFu;
// integer operations of the work count (the bound model of the note)
constexpr int CLOSE_OPS = 6;     // per word of a slot b < 5 pass
constexpr int CLOSE5_OPS = 4;    // per state row and receiving word, b >= 5
constexpr int PRUNE_OPS = 2;     // per word (receiving word at b >= 5)
constexpr int CLOSURE_OPS = 2;   // per (source, target) pair and word

__host__ __device__ constexpr uint32_t intra(int b) {
    return b == 0 ? 0x55555555u : b == 1 ? 0x33333333u
           : b == 2 ? 0x0F0F0F0Fu : b == 3 ? 0x00FF00FFu : 0x0000FFFFu;
}

template <int SNP, bool CLOSE>
struct Stage {
    int32_t ret[CHUNK];
    int32_t slot[CHUNK][I];
    uint32_t a1[CHUNK][I];
    uint32_t a2[CHUNK][I];
    int32_t t0[CHUNK][I];
    uint32_t cmask[CLOSE ? CHUNK : 1][SNP];
};

// One pass of slot B over this thread's word column, in place.
template <int WD, int SNP, int B>
__device__ __forceinline__ void pass(uint32_t (&fr)[SNP], uint32_t a1,
                                     uint32_t a2, int t0, int w) {
    if constexpr (B < 5) {
        constexpr uint32_t LACK = intra(B);
        constexpr int SH = 1 << B;
        uint32_t red = 0u;
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            const uint32_t c = fr[s] & LACK;
            red |= c & (0u - ((a2 >> s) & 1u));
            fr[s] |= (c & (0u - ((a1 >> s) & 1u))) << SH;
        }
#pragma unroll
        for (int s = 0; s < SNP; ++s)
            fr[s] |= s == t0 ? red << SH : 0u;
    } else if constexpr ((1 << (B - 5)) < WD) {
        constexpr int Q = B - 5;
        const uint32_t has = 0u - uint32_t((w >> Q) & 1);
        uint32_t red = 0u;
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            const uint32_t c = __shfl_xor_sync(FULL, fr[s], 1 << Q) & has;
            red |= c & (0u - ((a2 >> s) & 1u));
            fr[s] |= c & (0u - ((a1 >> s) & 1u));
        }
#pragma unroll
        for (int s = 0; s < SNP; ++s)
            fr[s] |= s == t0 ? red : 0u;
    }
}

// Prune the configs lacking slot B and clear its bit.
template <int WD, int SNP, int B>
__device__ __forceinline__ void retire(uint32_t (&fr)[SNP], int w) {
    if constexpr (B < 5) {
#pragma unroll
        for (int s = 0; s < SNP; ++s)
            fr[s] = (fr[s] & ~intra(B)) >> (1 << B);
    } else if constexpr ((1 << (B - 5)) < WD) {
        constexpr int Q = B - 5;
        const bool has = (w >> Q) & 1;
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            const uint32_t v = __shfl_xor_sync(FULL, fr[s], 1 << Q);
            fr[s] = has ? 0u : v;
        }
    }
}

// Close the column's states under the row's jumps, in place: row t takes
// every row s with s -> t allowed.  Reading rows already closed gives the
// same set, since the jumps are transitive.
template <int SNP>
__device__ __forceinline__ void close_states(uint32_t (&fr)[SNP],
                                             const uint32_t *cmask) {
    uint32_t cm[SNP];
#pragma unroll
    for (int s = 0; s < SNP; ++s) cm[s] = cmask[s];
#pragma unroll
    for (int t = 0; t < SNP; ++t) {
        uint32_t acc = fr[t];
#pragma unroll
        for (int s = 0; s < SNP; ++s)
            acc |= fr[s] & (0u - ((cm[s] >> t) & 1u));
        fr[t] = acc;
    }
}

}  // namespace

template <int WD, int SNP, bool CLOSE>
__global__ void __launch_bounds__(THREADS)
wgl_crash_kernel(const uint8_t *__restrict__ cbuf, long long nbytes,
                 const int64_t *__restrict__ offs,
                 const int32_t *__restrict__ nrows,
                 const uint32_t *__restrict__ aux, int UP,
                 const uint32_t *__restrict__ ctab, int nC, int R, int Sn,
                 int nc, int rn, int J, int death, uint32_t seed,
                 void *__restrict__ out, long long *__restrict__ work,
                 int32_t *__restrict__ bad) {
    __shared__ Stage<SNP, CLOSE> st;
    const int k = blockIdx.x;
    const int tid = threadIdx.x;
    const int g = blockIdx.y * blockDim.x + tid;
    const int j = g / WD;
    const int w = g % WD;
    const bool walker = blockIdx.y * blockDim.x + (tid & ~31) < J * WD;
    // this lane's WD threads in the warp's ballot
    const uint32_t grp = ((1u << WD) - 1u) << ((tid & 31) & ~(WD - 1));
    const long long off = offs[k];
    const int L = nrows[k];
    constexpr int RB = 1 + 3 * I + (CLOSE ? 2 : 0);
    if (L < 0 || off < 0 || off + (long long)RB * L > nbytes) {
        if (tid == 0 && blockIdx.y == 0) atomicAdd(bad, 1);
        return;                         // the whole block leaves together
    }
    const uint8_t *ret_b = cbuf + off;
    const uint8_t *isl_b = ret_b + L;
    const uint8_t *iu_b = ret_b + 3LL * L;
    const uint8_t *cr_b = ret_b + 7LL * L;

    uint32_t fr[SNP];
    const int cm0 = j / Sn, s0 = j % Sn, m0 = cm0 << rn;
#pragma unroll
    for (int s = 0; s < SNP; ++s) {
        uint32_t v = 0u;
        if (j < J) {
            if (death)
                v = (w == 0 && s < Sn) ? (seed >> s) & 1u : 0u;
            else
                v = (s == s0 && w == (m0 >> 5)) ? 1u << (m0 & 31) : 0u;
        }
        fr[s] = v;
    }
    uint32_t a1r[MAXR], a2r[MAXR];
    int t0r[MAXR];
#pragma unroll
    for (int b = 0; b < MAXR; ++b) {
        a1r[b] = 0u;
        a2r[b] = 0u;
        t0r[b] = 0;
    }
    uint32_t open = 0u;                 // bit b: slot b is open
    long long ops = 0;                  // this lane's integer operations
    const long long half = WD > 1 ? WD / 2 : 1;
    const long long pass_ops = (long long)CLOSE_OPS * Sn * WD;
    const long long pass5_ops = (long long)CLOSE5_OPS * Sn * half;
    const long long prune_ops = (long long)PRUNE_OPS * Sn * WD;
    const long long prune5_ops = (long long)PRUNE_OPS * Sn * half;
    const long long close_ops =
        CLOSE ? (long long)CLOSURE_OPS * Sn * Sn * WD : 0;
    int ok = 1;
    int dead = -1;

    for (int base = 0; base < L && dead < 0; base += CHUNK) {
        const int n = min(CHUNK, L - base);
        __syncthreads();
        for (int r = tid; r < n; r += blockDim.x) {
            const long long row = base + r;
            int rs = int(ret_b[row]) - 1;
            if (rs >= R) {
                ok = 0;
                rs = -1;
            }
            st.ret[r] = rs;
#pragma unroll
            for (int i = 0; i < I; ++i) {
                int sl = int(isl_b[row * I + i]) - 1;
                const long long c = 2 * (row * I + i);
                const int u = int(iu_b[c]) | (int(iu_b[c + 1]) << 8);
                if (sl >= 0 && (u >= UP || sl >= R)) {
                    ok = 0;
                    sl = -1;
                }
                st.slot[r][i] = sl;
                if (sl >= 0) {
                    st.a1[r][i] = aux[u];
                    st.a2[r][i] = aux[UP + u];
                    st.t0[r][i] = int(aux[2 * UP + u]);
                }
            }
            if constexpr (CLOSE) {
                int cr = int(int16_t(uint16_t(cr_b[2 * row])
                                     | (uint16_t(cr_b[2 * row + 1]) << 8)));
                if (cr < 0 || cr >= nC) {
                    ok = 0;
                    cr = 0;
                }
#pragma unroll
                for (int s = 0; s < SNP; ++s)
                    st.cmask[r][s] = s < Sn ? ctab[(long long)cr * Sn + s]
                                            : 0u;
            }
        }
        __syncthreads();
        if (!walker) continue;
        for (int r = 0; r < n; ++r) {
#pragma unroll
            for (int i = 0; i < I; ++i) {
                const int sl = st.slot[r][i];
                if (sl < 0) continue;
                const uint32_t a1 = st.a1[r][i], a2 = st.a2[r][i];
                const int t0 = st.t0[r][i];
#pragma unroll
                for (int b = 0; b < MAXR; ++b)
                    if (sl == b) {
                        a1r[b] = a1;
                        a2r[b] = a2;
                        t0r[b] = t0;
                    }
                open |= 1u << sl;
            }
            if constexpr (CLOSE) {
                close_states<SNP>(fr, st.cmask[r]);
                ops += close_ops;
            }
            if (open) {
                const long long per_round = __popc(open & 31u) * pass_ops
                                            + __popc(open >> 5) * pass5_ops
                                            + close_ops;
                int bits = 0;
#pragma unroll
                for (int s = 0; s < SNP; ++s) bits += __popc(fr[s]);
                bool run = true;        // the lane is short of its fixpoint
                for (int rd = 0; rd < R; ++rd) {
                    if (open & 1u)
                        pass<WD, SNP, 0>(fr, a1r[0], a2r[0], t0r[0], w);
                    if (open & 2u)
                        pass<WD, SNP, 1>(fr, a1r[1], a2r[1], t0r[1], w);
                    if (open & 4u)
                        pass<WD, SNP, 2>(fr, a1r[2], a2r[2], t0r[2], w);
                    if (open & 8u)
                        pass<WD, SNP, 3>(fr, a1r[3], a2r[3], t0r[3], w);
                    if (open & 16u)
                        pass<WD, SNP, 4>(fr, a1r[4], a2r[4], t0r[4], w);
                    if (open & 32u)
                        pass<WD, SNP, 5>(fr, a1r[5], a2r[5], t0r[5], w);
                    if (open & 64u)
                        pass<WD, SNP, 6>(fr, a1r[6], a2r[6], t0r[6], w);
                    if (open & 128u)
                        pass<WD, SNP, 7>(fr, a1r[7], a2r[7], t0r[7], w);
                    if constexpr (CLOSE) close_states<SNP>(fr, st.cmask[r]);
                    int now = 0;
#pragma unroll
                    for (int s = 0; s < SNP; ++s) now += __popc(fr[s]);
                    const uint32_t grew = __ballot_sync(FULL, now != bits);
                    bits = now;
                    if (run) ops += per_round;
                    run = run && (grew & grp) != 0u;
                    if (!grew) break;   // every lane of the warp is fixed
                }
            }
            const int rs = st.ret[r];
            if (rs >= 0) {
                switch (rs) {
                case 0: retire<WD, SNP, 0>(fr, w); break;
                case 1: retire<WD, SNP, 1>(fr, w); break;
                case 2: retire<WD, SNP, 2>(fr, w); break;
                case 3: retire<WD, SNP, 3>(fr, w); break;
                case 4: retire<WD, SNP, 4>(fr, w); break;
                case 5: retire<WD, SNP, 5>(fr, w); break;
                case 6: retire<WD, SNP, 6>(fr, w); break;
                case 7: retire<WD, SNP, 7>(fr, w); break;
                default: break;
                }
                open &= ~(1u << rs);
                ops += rs >= 5 ? prune5_ops : prune_ops;
            }
            if (death) {
                uint32_t any = 0u;
#pragma unroll
                for (int s = 0; s < SNP; ++s) any |= fr[s];
                if (!__any_sync(FULL, any != 0u)) {
                    dead = base + r;    // one warp walks: uniform
                    break;
                }
            }
        }
    }
    if (__syncthreads_or(!ok)) {
        if (tid == 0 && blockIdx.y == 0) atomicAdd(bad, 1);
        return;
    }
    if (death) {
        if (g == 0) static_cast<int32_t *>(out)[k] = dead;
    } else if (j < J) {
        uint8_t *o = static_cast<uint8_t *>(out) + ((long long)k * J + j) * J;
        for (int cm = 0; cm < (1 << nc); ++cm) {
            const int m = cm << rn;
            if (w != (m >> 5)) continue;
#pragma unroll
            for (int s = 0; s < SNP; ++s)
                if (s < Sn) o[cm * Sn + s] = uint8_t((fr[s] >> (m & 31)) & 1u);
        }
    }
    if (work && j < J && w == 0)
        atomicAdd(reinterpret_cast<unsigned long long *>(work) + k,
                  static_cast<unsigned long long>(ops));
}

namespace {

template <int WD, int SNP, bool CLOSE>
void launch_one(dim3 grid, int threads, cudaStream_t stream,
                const void *cbuf, long long nbytes, const void *offs,
                const void *nrows, const void *aux, int UP, const void *ctab,
                int nC, int R, int Sn, int nc, int rn, int J, int death,
                unsigned seed, void *out, void *work, void *bad) {
    wgl_crash_kernel<WD, SNP, CLOSE><<<grid, threads, 0, stream>>>(
        (const uint8_t *)cbuf, nbytes, (const int64_t *)offs,
        (const int32_t *)nrows, (const uint32_t *)aux, UP,
        (const uint32_t *)ctab, nC, R, Sn, nc, rn, J, death, seed, out,
        (long long *)work, (int32_t *)bad);
}

}  // namespace

// One launch over K segments on `stream`; returns the cudaError_t of the
// launch (0 on success).  `work`, when given, must hold K zeros.  ctab == NULL walks without the state closure
// (the crash variant, nc >= 0); with ctab (nC rows of Sn masks) nc must be
// 0 and R <= 6, and `death` != 0 seeds one lane with `seed` and writes
// int32 death rows instead of u8 transfer rows.  SnP is the state-row
// bucket (8, 16 or 32), Sn <= SnP the live states.
extern "C" int wgl_crash_launch(const void *cbuf, long long nbytes,
                                const void *offs, const void *nrows,
                                const void *aux, int UP, const void *ctab,
                                int nC, int K, int R, int SnP, int Sn, int nc,
                                int rn, int death, unsigned seed, void *out,
                                void *work, void *bad, void *stream) {
    if (K <= 0) return 0;
    const bool close = ctab != nullptr;
    const int J = death ? 1 : (Sn << nc);
    if (R < 1 || R > MAXR || Sn < 1 || Sn > SnP || nc < 0 || nc > 4 ||
        rn < 0 || rn + nc > R || J > 128 || UP < 1 ||
        (SnP != 8 && SnP != 16 && SnP != 32) ||
        (close && (nc != 0 || R > 6 || nC < 1)) || (death && !close))
        return (int)cudaErrorInvalidValue;
    const int wd = R <= 5 ? 1 : 1 << (R - 5);
    const int lanes = J * wd;
    const int threads = lanes >= THREADS ? THREADS : ((lanes + 31) / 32) * 32;
    const dim3 grid(K, (lanes + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
#define WGL_CRASH_CASE(WD, SNP, CL)                                          \
    if (wd == WD && SnP == SNP && close == CL)                               \
        launch_one<WD, SNP, CL>(grid, threads, s, cbuf, nbytes, offs, nrows, \
                                aux, UP, ctab, nC, R, Sn, nc, rn, J, death,  \
                                seed, out, work, bad);
    WGL_CRASH_CASE(1, 8, false)
    WGL_CRASH_CASE(1, 16, false)
    WGL_CRASH_CASE(1, 32, false)
    WGL_CRASH_CASE(2, 8, false)
    WGL_CRASH_CASE(2, 16, false)
    WGL_CRASH_CASE(2, 32, false)
    WGL_CRASH_CASE(4, 8, false)
    WGL_CRASH_CASE(4, 16, false)
    WGL_CRASH_CASE(4, 32, false)
    WGL_CRASH_CASE(8, 8, false)
    WGL_CRASH_CASE(8, 16, false)
    WGL_CRASH_CASE(8, 32, false)
    WGL_CRASH_CASE(1, 8, true)
    WGL_CRASH_CASE(1, 16, true)
    WGL_CRASH_CASE(1, 32, true)
    WGL_CRASH_CASE(2, 8, true)
    WGL_CRASH_CASE(2, 16, true)
    WGL_CRASH_CASE(2, 32, true)
#undef WGL_CRASH_CASE
    return (int)cudaGetLastError();
}
