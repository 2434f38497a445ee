// The packed boolean product of Elle's closure tier, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/elle_mesh.py::_device_fns.pmm (:261, an XLA
// program, not Pallas), the blocked product that the packed tier's
// closure rounds (_build_kernel :286, round_ :354-368) run four times a
// round: pmm unpacks (block x block) tiles of packed u32 rows to bf16,
// multiplies them with f32 accumulation, thresholds and packs again, so
// that device memory never holds a dense plane.
//
// What it computes.  Planes are n_pad x n_pad boolean matrices packed 32
// columns a word (bit b of word w is column 32 w + b), W = n_pad / 32
// words a row, row-major.  A job writes
//     out[i][w] = x[i][w] | OR over its terms t of (A_t . B_t)[i][w],
//     (A . B)[i][w] = OR over k with bit k of A[i] set of B[k][w],
// the exact boolean product, where A_t = a0 | a1 and B_t = b0 | b1 (a1,
// b1 may be null: the round's q = p0 | p1 is formed on the fly and never
// stored) and x may be null.  One launch runs up to MAX_JOBS jobs (grid
// z), all reading their inputs as they were before the launch: the
// round of elle_mesh.py:362-364 is three jobs,
//     cww' = cww | cww.cww,  p0' = p0 | p0.p0,  p1' = p1 | q.p1 | p1.q,
// written to new planes (Jacobi: the reference's while_loop computes a
// round from the old triple, and the round count is part of the verdict).
// `changed`, when given, is set to 1 if any job's out differs from its x
// anywhere; the wrapper zeroes it before the launch.
//
// Layout.  A CTA of 256 threads (8 warps) computes a tile of TR = 64 rows
// x 32 words: lane l of warp v holds words w0 + l of rows i0 + 8 v ..
// i0 + 8 v + 7 in registers.  For each term it walks k in chunks of KC =
// 128 bits: the A tile (64 rows x 4 words) is staged in shared memory;
// when it is all zero (__syncthreads_or) the chunk is skipped whole,
// else the B tile (128 rows x 32 words, 16 KB) is staged with coalesced
// loads, and every lane ORs B[k][its word] into each of its rows whose A
// bit k is set.  A warp's rows and bits are the same for all its lanes,
// so the tests are warp-uniform, and a warp skips a 32-bit A word that
// is zero in all its 8 rows.  Lanes past W (W = 316 at n_pad = 10112)
// load zeros and store nothing.
//
// What bounds it on this card.  The product is n_pad^2 W word steps (a
// bit test and a masked OR each, about 3 integer operations), where the
// tensor-core form (int8 mma on unpacked tiles) would do 2 n_pad^3 int8
// operations at 1,979 TOP/s; the packed bytes (each plane read once,
// each output written once) are n_pad^2 / 8 a plane.  So it is bound by
// its integer operations on the INT32 lanes, far from the int8 bound the
// wrapper prices; what the design does about it is to skip zero words,
// which makes a sparse round (the early rounds of most histories) cheap.
// Tensor cores, TMA and wgmma are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads a CTA
constexpr int RW = 8;             // rows a warp
constexpr int TR = RW * NT / 32;  // rows a CTA (64)
constexpr int TWD = 32;           // words a CTA (one a lane)
constexpr int KC = 128;           // bits of k a staged chunk
constexpr int KW = KC / 32;       // A words a row in a chunk (4)
constexpr int MAX_JOBS = 4;
constexpr int MAX_TERMS = 2;

struct Term {
    const uint32_t *a0, *a1, *b0, *b1;
};

struct Job {
    const uint32_t *x;
    uint32_t *out;
    Term t[MAX_TERMS];
    int nterms;
};

struct Jobs {
    Job j[MAX_JOBS];
};

}  // namespace

// R rows a warp (the template argument names the instantiation in
// ptxas's report).
template <int R>
__global__ void __launch_bounds__(NT)
elle_pmm_kernel(const Jobs jobs, int n_pad, int W, int *changed) {
    static_assert(R == RW, "one instantiation");
    __shared__ uint32_t As[TR][KW];
    __shared__ uint32_t Bs[KC][TWD];
    const Job &job = jobs.j[blockIdx.z];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int i0 = blockIdx.y * TR;
    const int w0 = blockIdx.x * TWD;
    const int w = w0 + lane;
    const bool live = w < W;

    uint32_t acc[RW];
    uint32_t old[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int i = i0 + warp * RW + r;
        old[r] = (job.x != nullptr && live) ? job.x[(size_t)i * W + w] : 0u;
        acc[r] = old[r];
    }

    for (int t = 0; t < job.nterms; ++t) {
        const Term term = job.t[t];
        for (int k0 = 0; k0 < n_pad; k0 += KC) {
            __syncthreads();    // the last chunk's tiles are consumed
            {
                // one A word a thread: row tid / KW, word tid % KW
                const int r = tid / KW, j = tid % KW;
                const size_t at = (size_t)(i0 + r) * W + (k0 >> 5) + j;
                uint32_t a = term.a0[at];
                if (term.a1 != nullptr) a |= term.a1[at];
                As[r][j] = a;
                if (!__syncthreads_or(a != 0u)) continue;
            }
            for (int idx = tid; idx < KC * TWD; idx += NT) {
                const int r = idx / TWD, c = idx % TWD;
                uint32_t b = 0u;
                if (w0 + c < W) {
                    const size_t at = (size_t)(k0 + r) * W + w0 + c;
                    b = term.b0[at];
                    if (term.b1 != nullptr) b |= term.b1[at];
                }
                Bs[r][c] = b;
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < KW; ++j) {
                uint32_t aw[RW];
                uint32_t any = 0u;
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    aw[r] = As[warp * RW + r][j];
                    any |= aw[r];
                }
                if (any == 0u) continue;    // warp-uniform
#pragma unroll 8
                for (int bit = 0; bit < 32; ++bit) {
                    const uint32_t bw = Bs[j * 32 + bit][lane];
#pragma unroll
                    for (int r = 0; r < RW; ++r)
                        acc[r] |= bw & (0u - ((aw[r] >> bit) & 1u));
                }
            }
        }
    }

    bool diff = false;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int i = i0 + warp * RW + r;
        if (live) job.out[(size_t)i * W + w] = acc[r];
        diff |= acc[r] != old[r];
    }
    if (changed != nullptr && __any_sync(0xffffffffu, diff) && lane == 0)
        *changed = 1;
}

// ptrs holds, for each of njobs jobs, ten pointers: x, out, then for
// terms 0 and 1 a0, a1, b0, b1 (x, a1, b1 and an unused term's may be
// null); nterms[j] is job j's term count (1 or 2).  Every plane is
// n_pad x n_pad / 32 u32 words, contiguous; n_pad a multiple of 128.
// Returns the launch's cudaError (0 on success).
extern "C" int elle_pmm_launch(const void *const *ptrs, const int *nterms,
                               int njobs, int n_pad, void *changed,
                               void *stream) {
    if (njobs < 1 || njobs > MAX_JOBS || n_pad < TR || n_pad % 128 != 0)
        return (int)cudaErrorInvalidValue;
    Jobs jobs = {};
    for (int j = 0; j < njobs; ++j) {
        const void *const *p = ptrs + 10 * j;
        Job &job = jobs.j[j];
        job.x = (const uint32_t *)p[0];
        job.out = (uint32_t *)p[1];
        job.nterms = nterms[j];
        if (job.out == nullptr || job.nterms < 1 || job.nterms > MAX_TERMS)
            return (int)cudaErrorInvalidValue;
        for (int t = 0; t < MAX_TERMS; ++t) {
            job.t[t].a0 = (const uint32_t *)p[2 + 4 * t];
            job.t[t].a1 = (const uint32_t *)p[3 + 4 * t];
            job.t[t].b0 = (const uint32_t *)p[4 + 4 * t];
            job.t[t].b1 = (const uint32_t *)p[5 + 4 * t];
            if (t < job.nterms &&
                (job.t[t].a0 == nullptr || job.t[t].b0 == nullptr))
                return (int)cudaErrorInvalidValue;
        }
    }
    const int W = n_pad / 32;
    dim3 grid((W + TWD - 1) / TWD, n_pad / TR, njobs);
    elle_pmm_kernel<RW><<<grid, NT, 0, (cudaStream_t)stream>>>(
        jobs, n_pad, W, (int *)changed);
    return (int)cudaGetLastError();
}
