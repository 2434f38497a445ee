// Register-delta segment scan for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgl_seg.py::_build_kernel_regs (:258, an XLA
// lax.scan, not Pallas) on the path of its nc = 0 callers: the composed
// single-history kernel and the grouped pipeline kernel
// _build_kernel_regs_group_c (:641), whose in-kernel wire unpack
// (_unpack_transfer_bufs, :522) is folded into this kernel's staging.
// It computes, for every lane (segment k, entry state j), the transfer
// row T[k, j, :]: the model states reachable at the segment's end, at
// mask 0, having entered the segment in state j.
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
//   2. `rounds` closure rounds, Jacobi style: every open slot b adds
//      set_slot(moved_b) computed from the plane as it was at the start
//      of the round, where moved_b = (contrib & diag(a1)) plus, at state
//      t0, the OR over states of (contrib & const(a2)), and contrib is
//      the configs lacking b;
//   3. at a return of slot rs, prune the configs lacking rs and clear
//      its bit, and retire the slot.  A virtual row (no return) prunes
//      nothing.
// rounds = R is exact (every config reachable by <= R linearizations is
// in); the pipeline runs fewer, an under-approximation whose deaths the
// host re-checks at rounds = R.
//
// Layout.  One thread per lane; one warp per segment, lane j < J walking
// entry state j (J is a launch parameter, at most 32), the other lanes
// walking an empty plane.  The lanes of a segment share its event rows,
// which the warp stages CHUNK rows at a time into shared memory (ret,
// slot, and the slot's three table words gathered from the aux table),
// between two __syncwarp.  Each warp walks its own segment's row count.
// Every decision in the walk (which slots are open, the returning slot)
// is the segment's, so the warp never diverges; no lane reads another
// lane's plane: the closure's OR over source states stays inside one
// lane's words.  The kernel is templated on (WD, SnP) and fully
// unrolled, so the plane and the slot tables stay in registers.
//
// What bounds it on this card: integer operations.  A closure pass of
// a slot b < 5 costs six operations per plane word (select the configs
// lacking the slot, the diagonal select, the shift, the OR into the
// round's sum, the rank-1 select, the OR over states), one of slot 5
// four per state row (no lack mask, no shift: word 0 moves to word 1),
// and a prune two per word (the and-not and the shift; at slot 5 the
// move and the clear per state row).  The wire is a few bytes a row,
// and the plane never leaves registers.  The design gives every lane its
// own thread and keeps the warp convergent, so the integer lanes do the
// walk and nothing waits on memory or on a barrier after staging; a
// segment with J < 32 entry states leaves 32 - J lanes idle, which is
// the cost of that simplicity.
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
// under the costs above, summed over its J lanes: per row, rounds passes
// of every open slot over the Sn state rows that hold configs (rows Sn..
// SnP-1 of the plane stay empty and are not counted), and a prune at a
// return.  The per-row mask extraction, the landing at t0 and the OR of
// a round's sum are left out, so the count is a floor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXR = 6;          // deepest overlap the kernel walks
constexpr int I = 2;             // invoke columns per event row
constexpr int WARPS = 4;         // segments per block, one per warp
constexpr int CHUNK = 64;        // event rows staged per step
constexpr int MAXJ = 32;         // entry states per segment (one warp)
// integer operations of the work count (the bound model of the note)
constexpr int CLOSE_OPS = 6;     // per plane word of a slot b < 5 pass
constexpr int CLOSE5_OPS = 4;    // per state row of a slot 5 pass
constexpr int PRUNE_OPS = 2;     // per plane word (state row at slot 5)

// Bit i of intra(b) is set iff mask index i lacks bit b (b < 5).
__host__ __device__ constexpr uint32_t intra(int b) {
    return b == 0 ? 0x55555555u : b == 1 ? 0x33333333u
           : b == 2 ? 0x0F0F0F0Fu : b == 3 ? 0x00FF00FFu : 0x0000FFFFu;
}

struct Stage {
    int32_t ret[CHUNK];
    int32_t slot[CHUNK][I];
    uint32_t a1[CHUNK][I];
    uint32_t a2[CHUNK][I];
    int32_t t0[CHUNK][I];
};

// One closure pass of slot B over the plane `fr`, added into `add`.
template <int WD, int SNP, int B>
__device__ __forceinline__ void close_slot(const uint32_t (&fr)[SNP][WD],
                                           uint32_t (&add)[SNP][WD],
                                           uint32_t a1, uint32_t a2,
                                           int t0) {
    if constexpr (B < 5) {
        constexpr uint32_t LACK = intra(B);
        constexpr int SH = 1 << B;
        uint32_t red[WD];
#pragma unroll
        for (int w = 0; w < WD; ++w) red[w] = 0u;
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            const uint32_t dm = 0u - ((a1 >> s) & 1u);
            const uint32_t cm = 0u - ((a2 >> s) & 1u);
#pragma unroll
            for (int w = 0; w < WD; ++w) {
                const uint32_t c = fr[s][w] & LACK;
                add[s][w] |= (c & dm) << SH;
                red[w] |= c & cm;
            }
        }
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            const uint32_t tm = s == t0 ? 0xFFFFFFFFu : 0u;
#pragma unroll
            for (int w = 0; w < WD; ++w) add[s][w] |= (red[w] & tm) << SH;
        }
    } else if constexpr (WD == 2) {
        // slot 5: word 0 lacks it; linearizing moves word 0 to word 1
        uint32_t red = 0u;
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            const uint32_t dm = 0u - ((a1 >> s) & 1u);
            const uint32_t cm = 0u - ((a2 >> s) & 1u);
            const uint32_t c = fr[s][0];
            add[s][1] |= c & dm;
            red |= c & cm;
        }
#pragma unroll
        for (int s = 0; s < SNP; ++s)
            add[s][1] |= s == t0 ? red : 0u;
    }
}

// Prune the configs lacking slot B and clear its bit.
template <int WD, int SNP, int B>
__device__ __forceinline__ void retire_slot(uint32_t (&fr)[SNP][WD]) {
    if constexpr (B < 5) {
#pragma unroll
        for (int s = 0; s < SNP; ++s)
#pragma unroll
            for (int w = 0; w < WD; ++w)
                fr[s][w] = (fr[s][w] & ~intra(B)) >> (1 << B);
    } else if constexpr (WD == 2) {
#pragma unroll
        for (int s = 0; s < SNP; ++s) {
            fr[s][0] = fr[s][1];
            fr[s][1] = 0u;
        }
    }
}

}  // namespace

template <int WD, int SNP>
__global__ void __launch_bounds__(32 * WARPS)
wgl_regs_kernel(const uint8_t *__restrict__ cbuf, long long nbytes,
                const int64_t *__restrict__ offs,
                const int32_t *__restrict__ nrows,
                const uint32_t *__restrict__ aux, int UP, int K, int R,
                int J, int Sn, int rounds, uint8_t *__restrict__ out,
                long long *__restrict__ work, int32_t *__restrict__ bad) {
    __shared__ Stage stage[WARPS];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int k = blockIdx.x * WARPS + warp;
    if (k >= K) return;                 // the whole warp leaves together
    Stage &st = stage[warp];
    const long long off = offs[k];
    const int L = nrows[k];
    if (L < 0 || off < 0 || off + 7LL * L > nbytes) {
        if (lane == 0) atomicAdd(bad, 1);
        return;
    }
    const uint8_t *ret_b = cbuf + off;
    const uint8_t *isl_b = ret_b + L;
    const uint8_t *iu_b = ret_b + 3LL * L;

    uint32_t fr[SNP][WD];
#pragma unroll
    for (int s = 0; s < SNP; ++s)
#pragma unroll
        for (int w = 0; w < WD; ++w)
            fr[s][w] = (w == 0 && s == lane && lane < J) ? 1u : 0u;
    uint32_t a1r[MAXR], a2r[MAXR];
    int t0r[MAXR];
#pragma unroll
    for (int b = 0; b < MAXR; ++b) {
        a1r[b] = 0u;
        a2r[b] = 0u;
        t0r[b] = 0;
    }
    uint32_t open = 0u;                 // bit b: slot b is open
    long long ops = 0;
    const long long pass_ops = (long long)CLOSE_OPS * Sn * WD;
    const long long pass5_ops = (long long)CLOSE5_OPS * Sn;
    const long long prune_ops = (long long)PRUNE_OPS * Sn * WD;
    const long long prune5_ops = (long long)PRUNE_OPS * Sn;
    int ok = 1;

    for (int base = 0; base < L; base += CHUNK) {
        const int n = min(CHUNK, L - base);
        __syncwarp();
        for (int r = lane; r < n; r += 32) {
            const long long row = base + r;
            st.ret[r] = int(ret_b[row]) - 1;
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
        }
        __syncwarp();
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
            if (open) {
                for (int rd = 0; rd < rounds; ++rd) {
                    uint32_t add[SNP][WD];
#pragma unroll
                    for (int s = 0; s < SNP; ++s)
#pragma unroll
                        for (int w = 0; w < WD; ++w) add[s][w] = 0u;
                    if (open & 1u)
                        close_slot<WD, SNP, 0>(fr, add, a1r[0], a2r[0], t0r[0]);
                    if (open & 2u)
                        close_slot<WD, SNP, 1>(fr, add, a1r[1], a2r[1], t0r[1]);
                    if (open & 4u)
                        close_slot<WD, SNP, 2>(fr, add, a1r[2], a2r[2], t0r[2]);
                    if (open & 8u)
                        close_slot<WD, SNP, 3>(fr, add, a1r[3], a2r[3], t0r[3]);
                    if (open & 16u)
                        close_slot<WD, SNP, 4>(fr, add, a1r[4], a2r[4], t0r[4]);
                    if (open & 32u)
                        close_slot<WD, SNP, 5>(fr, add, a1r[5], a2r[5], t0r[5]);
#pragma unroll
                    for (int s = 0; s < SNP; ++s)
#pragma unroll
                        for (int w = 0; w < WD; ++w) fr[s][w] |= add[s][w];
                }
                ops += rounds * (__popc(open & 31u) * pass_ops
                                 + ((open >> 5) & 1u) * pass5_ops);
            }
            const int rs = st.ret[r];
            if (rs >= R) {
                ok = 0;
            } else if (rs >= 0) {
                switch (rs) {
                case 0: retire_slot<WD, SNP, 0>(fr); break;
                case 1: retire_slot<WD, SNP, 1>(fr); break;
                case 2: retire_slot<WD, SNP, 2>(fr); break;
                case 3: retire_slot<WD, SNP, 3>(fr); break;
                case 4: retire_slot<WD, SNP, 4>(fr); break;
                case 5: retire_slot<WD, SNP, 5>(fr); break;
                default: ok = 0; break;
                }
                open &= ~(1u << (rs & 31));
                ops += rs == 5 ? prune5_ops : prune_ops;
            }
        }
    }
    if (!__all_sync(0xFFFFFFFFu, ok)) {
        if (lane == 0) atomicAdd(bad, 1);
        return;
    }
    if (lane < J) {
        uint8_t *o = out + ((long long)k * J + lane) * Sn;
#pragma unroll
        for (int s = 0; s < SNP; ++s)
            if (s < Sn) o[s] = uint8_t(fr[s][0] & 1u);
    }
    if (lane == 0 && work) work[k] = ops * J;
}

namespace {

template <int WD, int SNP>
void launch_one(dim3 grid, cudaStream_t stream, const void *cbuf,
                long long nbytes, const void *offs, const void *nrows,
                const void *aux, int UP, int K, int R, int J, int Sn,
                int rounds, void *out, void *work, void *bad) {
    wgl_regs_kernel<WD, SNP><<<grid, 32 * WARPS, 0, stream>>>(
        (const uint8_t *)cbuf, nbytes, (const int64_t *)offs,
        (const int32_t *)nrows, (const uint32_t *)aux, UP, K, R, J, Sn,
        rounds, (uint8_t *)out, (long long *)work, (int32_t *)bad);
}

}  // namespace

// One launch over K segments on `stream`; returns the cudaError_t of the
// launch (0 on success).  R sizes the plane (WD = 2 at R = 6), SnP is
// the state-row bucket (8, 16 or 32) and Sn <= SnP the states written.
extern "C" int wgl_regs_launch(const void *cbuf, long long nbytes,
                               const void *offs, const void *nrows,
                               const void *aux, int UP, int K, int R,
                               int SnP, int Sn, int J, int rounds, void *out,
                               void *work, void *bad, void *stream) {
    if (K <= 0) return 0;
    if (R < 1 || R > MAXR || J < 1 || J > MAXJ || Sn < 1 || Sn > SnP ||
        rounds < 1 || UP < 1 || (SnP != 8 && SnP != 16 && SnP != 32))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((K + WARPS - 1) / WARPS);
    cudaStream_t s = (cudaStream_t)stream;
    const int wd = R <= 5 ? 1 : 2;
#define WGL_REGS_CASE(WD, SNP)                                              \
    if (wd == WD && SnP == SNP)                                             \
        launch_one<WD, SNP>(grid, s, cbuf, nbytes, offs, nrows, aux, UP, K, \
                            R, J, Sn, rounds, out, work, bad);
    WGL_REGS_CASE(1, 8)
    WGL_REGS_CASE(1, 16)
    WGL_REGS_CASE(1, 32)
    WGL_REGS_CASE(2, 8)
    WGL_REGS_CASE(2, 16)
    WGL_REGS_CASE(2, 32)
#undef WGL_REGS_CASE
    return (int)cudaGetLastError();
}
