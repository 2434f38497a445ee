// The candidate-table walk, for Hopper (sm_90a): two entry points of one
// kernel template.
//
// Replaces jepsen_tpu/ops/wgl_seg.py::_build_kernel_bits (:105, B3b) and
// _build_kernel (:787, B3d), XLA scans (not Pallas) that _dispatch_kernel
// (:943) picks between.  Both compute, for every lane (segment k, entry
// state j), the transfer row T[k][j][s]: the configurations (linearized
// call mask m, model state s) the lane's walk reaches from (0, j) (from
// (0, 0) when J = 1), read at mask 0 after its last return.  Per return
// row r of the padded tables (ret[L][K], cslot[L][K][C]):
//
//   closure  every candidate c (an open call: its slot b and its op)
//            adds, for each config lacking b, the config with b set and
//            the state moved by the op; rounds until nothing changes (at
//            most R: a config takes one linearization a round);
//   retire   at a return of slot rs, the configs lacking rs are dropped
//            and rs's bit is cleared (mask m takes mask m | 1 << rs).
//
// The reference's dense scan stops a closure by Lowe's rule (no round
// when every config holds the returning call); the fixpoint reaches the
// same transfer rows, since an open call linearized later reaches what
// it reached earlier.  Padding is a no-op: a return -1 retires nothing,
// and a candidate whose masks are 0 (a -1 of the tables) moves nothing.
//
// Forms of a candidate's transition (template FORM):
//   0  wgl_cand_bits, decomposed: per-candidate diag mask a1, rank-1 mask
//      a2, target t0 (planner._pack_cand_tables, Sn <= 32): a state set x
//      goes to (x & a1) | (x & a2 ? 1 << t0 : 0);
//   1  wgl_cand_bits, undecomposed (Sn <= 8): legal mask a1, next states
//      in the nibbles of a2;
//   2  wgl_cand_dense, decomposed: the candidate's uop id indexes
//      tab[U][3] = (diag, const, t0), 64-bit masks (Sn <= 64);
//   3  wgl_cand_dense, undecomposed: tab[u][0] the legal mask, nxt[u][s]
//      the next state of s.
//
// Layout.  A lane's frontier is M = 2^R 64-bit state sets (bit s = state
// s), one thread per mask, in shared memory: a CTA holds LPC = max(1,
// 128 / M) lanes, LPC * M threads (up to 1024 at R = 10).  A closure round
// is Jacobi: each thread reads its partner masks m ^ (1 << b) for the
// candidates whose slot m holds, then after a barrier writes its own set;
// __syncthreads_or ends the rounds when no set of the CTA changed.  Each
// row's candidates are staged in shared memory (one 24-byte record each),
// read by a lane's threads as broadcasts.  Every thread of a lane follows
// the same candidates, so the only divergence is a mask's slot test.
//
// What bounds it: integer operations and the barriers of each round, for
// a lane's rows walked as one dependent chain.  The state set is 64 bits
// (two 32-bit words past Sn = 32); an undecomposed transition loops over
// the set's legal states.  A simple kernel: no staging of the next rows,
// no early exit of lanes whose rounds end before their CTA's.
//
// A CTA in which a live candidate or a return names a slot at or past R,
// or a candidate a uop outside the table, adds one to *bad and writes no
// output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CMAX = 16;         // candidates a row at most
constexpr int MAXT = 1024;       // threads a CTA at most (M = 2^10)
constexpr int MINT = 128;        // threads a CTA at least, where M allows

struct Cand {
    uint64_t a;                  // diag or legal mask
    uint64_t b;                  // const mask, or the nibbles
    int slot;                    // -1: moves nothing
    int x;                       // t0, or the uop id of the table form
};

template <int FORM>
__device__ __forceinline__ uint64_t trans(const Cand &c, uint64_t src,
                                          const uint8_t *__restrict__ nxt,
                                          int Sn) {
    if constexpr (FORM == 0 || FORM == 2) {
        return (src & c.a) | ((src & c.b) ? (1ull << c.x) : 0ull);
    } else if constexpr (FORM == 1) {
        // Sn <= 8: each legal state's target from its nibble
        const uint32_t x = uint32_t(src & c.a), nib = uint32_t(c.b);
        uint32_t out = 0u;
#pragma unroll
        for (int s = 0; s < 8; ++s)
            out |= ((x >> s) & 1u) << ((nib >> (4 * s)) & 15u);
        return out;
    } else {
        // each legal state's target from the uop's row of nxt, one
        // 32-bit half of the set at a time
        const uint8_t *row = nxt + c.x * Sn;
        uint64_t out = 0ull;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            uint32_t x = uint32_t((src & c.a) >> (32 * h));
#pragma unroll 1
            while (x) {
                const int s = 32 * h + __ffs(x) - 1;
                x &= x - 1u;
                out |= 1ull << row[s];
            }
        }
        return out;
    }
}

}  // namespace

template <int FORM>
__global__ void __launch_bounds__(MAXT, 1)
wgl_cand_kernel(const int32_t *__restrict__ ret,
                const int32_t *__restrict__ cslot,
                const int32_t *__restrict__ c1,
                const int32_t *__restrict__ c2,
                const int32_t *__restrict__ c3,
                const long long *__restrict__ tab,
                const uint8_t *__restrict__ nxt, int U, int L, int K, int C,
                int R, int Sn, int J, int LPC, uint8_t *__restrict__ out,
                int32_t *__restrict__ bad) {
    extern __shared__ uint64_t smem[];
    const int M = 1 << R;
    uint64_t *S = smem;                                  // [LPC][M]
    Cand *cs = reinterpret_cast<Cand *>(smem + (size_t)LPC * M);  // [LPC][C]
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lt = tid / M, m = tid % M;
    const int lanes = K * J;
    const int g = blockIdx.x * LPC + lt;
    const bool real = g < lanes;
    const int k = real ? g / J : 0, j = real ? g % J : 0;
    uint64_t mine = real && m == 0 ? (J == 1 ? 1ull : 1ull << j) : 0ull;
    S[tid] = mine;
    int refused = 0;
    const Cand *mc = cs + (size_t)lt * C;
    for (int r = 0; r < L; ++r) {
        __syncthreads();                 // the last row's reads are done
        for (int x = tid; x < LPC * C; x += nt) {
            const int l = x / C, c = x % C;
            const int gg = blockIdx.x * LPC + l;
            Cand cd{0ull, 0ull, -1, 0};
            if (gg < lanes) {
                const long long e = ((long long)r * K + gg / J) * C + c;
                const int sl = cslot[e];
                if constexpr (FORM <= 1) {
                    cd.a = uint32_t(c1[e]);
                    cd.b = uint32_t(c2[e]);
                    cd.x = c3[e];
                } else {
                    const int u = c1[e];
                    if (u >= U) {
                        refused = 1;
                    } else if (u >= 0) {
                        cd.a = (uint64_t)tab[3LL * u];
                        if constexpr (FORM == 2) {
                            cd.b = (uint64_t)tab[3LL * u + 1];
                            cd.x = int(tab[3LL * u + 2]);
                        } else {
                            cd.x = u;
                        }
                    }
                }
                const bool live = FORM == 1 || FORM == 3 ? cd.a != 0ull
                                                         : (cd.a | cd.b) != 0ull;
                if (live && (sl < 0 || sl >= R)) refused = 1;
                else if (live) cd.slot = sl;
            }
            cs[x] = cd;
        }
        __syncthreads();
        for (int rd = 0; rd < R; ++rd) {
            uint64_t add = 0ull;
            for (int c = 0; c < C; ++c) {
                const Cand cd = mc[c];
                if (cd.slot < 0 || !((m >> cd.slot) & 1)) continue;
                const uint64_t src = S[lt * M + (m ^ (1 << cd.slot))];
                if (src) add |= trans<FORM>(cd, src, nxt, Sn);
            }
            const uint64_t nw = mine | add;
            __syncthreads();
            S[tid] = nw;
            const int changed = __syncthreads_or(nw != mine);
            mine = nw;
            if (!changed) break;
        }
        int rs = real ? ret[(long long)r * K + k] : -1;
        if (rs >= R) {
            refused = 1;
            rs = -1;
        }
        uint64_t nv = mine;
        if (rs >= 0) nv = (m >> rs) & 1 ? 0ull : S[lt * M + (m | (1 << rs))];
        __syncthreads();
        S[tid] = nv;
        mine = nv;
    }
    if (__syncthreads_or(refused)) {
        if (tid == 0) atomicAdd(bad, 1);
        return;
    }
    if (real) {
        const uint64_t s0 = S[lt * M];
        uint8_t *o = out + ((long long)k * J + j) * Sn;
        for (int s = m; s < Sn; s += M) o[s] = uint8_t((s0 >> s) & 1ull);
    }
}

namespace {

template <int FORM>
int launch_one(int blocks, int threads, size_t smem, cudaStream_t st,
               const void *ret, const void *cslot, const void *c1,
               const void *c2, const void *c3, const void *tab,
               const void *nxt, int U, int L, int K, int C, int R, int Sn,
               int J, int LPC, void *out, void *bad) {
    auto kern = wgl_cand_kernel<FORM>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<blocks, threads, smem, st>>>(
        (const int32_t *)ret, (const int32_t *)cslot, (const int32_t *)c1,
        (const int32_t *)c2, (const int32_t *)c3, (const long long *)tab,
        (const uint8_t *)nxt, U, L, K, C, R, Sn, J, LPC, (uint8_t *)out,
        (int32_t *)bad);
    return (int)cudaGetLastError();
}

}  // namespace

// One launch over K * J lanes on `stream`: form 0 / 1 (wgl_cand_bits:
// c1, c2, c3 the per-candidate a1, a2, t0 int32[L][K][C]) or 2 / 3
// (wgl_cand_dense: c1 the uop ids int32[L][K][C], tab int64[U][3], nxt
// uint8[U][Sn] for form 3).  ret int32[L][K], cslot int32[L][K][C]; out
// uint8[K][J][Sn]; bad must hold 0.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int wgl_cand_launch(int form, const void *ret, const void *cslot,
                               const void *c1, const void *c2, const void *c3,
                               const void *tab, const void *nxt, int U,
                               int L, int K, int C, int R, int Sn, int J,
                               void *out, void *bad, void *stream) {
    if (K <= 0 || L <= 0) return 0;
    if (form < 0 || form > 3 || R < 1 || R > 10 || C < 1 || C > CMAX ||
        Sn < 1 || Sn > 64 || (J != 1 && J != Sn) ||
        (form == 0 && Sn > 32) || (form == 1 && Sn > 8) ||
        (form >= 2 && (U < 0 || tab == nullptr)) ||
        (form == 3 && nxt == nullptr))
        return (int)cudaErrorInvalidValue;
    const int M = 1 << R;
    const int LPC = M >= MINT ? 1 : MINT / M;
    const int threads = LPC * M;
    const long long lanes = (long long)K * J;
    if (lanes >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const int blocks = int((lanes + LPC - 1) / LPC);
    const size_t smem = (size_t)LPC * M * sizeof(uint64_t)
                        + (size_t)LPC * C * sizeof(Cand);
    cudaStream_t st = (cudaStream_t)stream;
#define WGL_CAND_CASE(F)                                                    \
    if (form == F)                                                          \
        return launch_one<F>(blocks, threads, smem, st, ret, cslot, c1, c2, \
                             c3, tab, nxt, U, L, K, C, R, Sn, J, LPC, out,  \
                             bad);
    WGL_CAND_CASE(0)
    WGL_CAND_CASE(1)
    WGL_CAND_CASE(2)
    WGL_CAND_CASE(3)
#undef WGL_CAND_CASE
    return (int)cudaErrorInvalidValue;
}
