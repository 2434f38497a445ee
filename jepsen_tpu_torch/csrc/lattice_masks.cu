// The full lattice's twelve class masks and their defining edges, for
// Hopper (sm_90a).
//
// Replaces the masks and picks of
// jepsen_tpu/lattice/engine.py::_build_mesh_kernel (masks :352-362, pick
// :284 and :363-367; an XLA program, not Pallas). After the packed tier's
// closures (rounds of elle_pmm, ops/lattice_kernel.py), every class is a
// mask `defining_plane & closure.T`, priority-subtracted in
// LATTICE_CLASSES order so that one defining edge belongs to one class:
//
//     dep = t_p0a | t_p1a
//     MW  = so_ww & dep            WFR = so_rw & dep & ~MW
//     RYW = so_wr & dep & ~MW & ~WFR
//     MR  = so_rr & dep & ~MW & ~WFR & ~RYW
//     sess = MW | WFR | RYW | MR,  so = so_ww | so_wr | so_rw | so_rr
//     PRAM   = so & t_p0s & ~sess
//     causal = so & t_p1s & ~t_p0s & ~sess & ~PRAM
//     LF     = rw & t_lf & ~t_p0a
//     G0 = ww & t_cww,  G1c = wr & t_p0a,  G-single = rw & t_p0a,
//     G2-item = rw & t_p1a & ~t_p0a & ~LF,  G2-predicate = prw & t_cpred
//
// and each class's defining edge is its mask's lowest flat bit index
// a * n_pad + b (row-major, the reference's pick and the dense tier's
// flat argmax).
//
// What it computes. Fifteen n_pad x n_pad boolean planes packed 32
// columns a word (bit b of word w is column 32 w + b), W = n_pad / 32
// words a row, n_pad a multiple of 128: the eight input planes (ww, wr,
// rw, so_ww, so_wr, so_rw, so_rr, prw) and seven packed transposes
// (t_p0a, t_p1a, t_p0s, t_p1s, t_cww, t_cpred, t_lf). Word f of a plane
// holds flat bits 32 f .. 32 f + 31, so a mask word's lowest bit is
// 32 f + ctz(word). out is u64[12] (int64 to the caller): each class's
// least flat index, or all ones (-1) where its mask is empty.
//
// Design: a grid-stride pass over the words, four at a time (16-byte
// loads of each of the 15 planes, neighbouring threads on neighbouring
// addresses). A thread walks its words in increasing order, so its first
// hit of a class is its least. Each warp reduces its lanes' minima with
// shuffles, the CTA's warps through shared memory, and one 64-bit
// atomicMin per class per CTA writes the result; the launch first sets
// out to all ones.
//
// What bounds it on this card: memory. The function reads each of the
// 15 planes once (15 n_pad^2 / 8 bytes) and writes 96 bytes; at n_pad
// 10,112 that is 191,723,520 bytes, 0.0572 ms at 3.35 TB/s. The masks are
// a few dozen integer operations per word, far below the INT32 lanes'
// rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // 8 warps a CTA
constexpr int NWARPS = NT / 32;
constexpr int NCLASS = 12;
constexpr int NPLANES = 8;
constexpr int NTPOSE = 7;
constexpr int CTAS_PER_SM = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;

struct Planes {
    const uint4 *p[NPLANES];            // ww wr rw so_ww so_wr so_rw so_rr prw
    const uint4 *t[NTPOSE];             // p0a p1a p0s p1s cww cpred lf
};

__device__ __forceinline__ void masks_of(const uint32_t *p, const uint32_t *t,
                                         uint32_t *m) {
    const uint32_t ww = p[0], wr = p[1], rw = p[2];
    const uint32_t so_ww = p[3], so_wr = p[4], so_rw = p[5], so_rr = p[6];
    const uint32_t prw = p[7];
    const uint32_t t_p0a = t[0], t_p1a = t[1], t_p0s = t[2], t_p1s = t[3];
    const uint32_t t_cww = t[4], t_cpred = t[5], t_lf = t[6];
    const uint32_t dep = t_p0a | t_p1a;
    const uint32_t so = so_ww | so_wr | so_rw | so_rr;
    const uint32_t mw = so_ww & dep;
    const uint32_t wfr = so_rw & dep & ~mw;
    const uint32_t ryw = so_wr & dep & ~mw & ~wfr;
    const uint32_t mr = so_rr & dep & ~mw & ~wfr & ~ryw;
    const uint32_t sess = mw | wfr | ryw | mr;
    const uint32_t pram = so & t_p0s & ~sess;
    const uint32_t causal = so & t_p1s & ~t_p0s & ~sess & ~pram;
    const uint32_t lf = rw & t_lf & ~t_p0a;
    m[0] = mw;
    m[1] = wfr;
    m[2] = ryw;
    m[3] = mr;
    m[4] = pram;
    m[5] = causal;
    m[6] = lf;
    m[7] = ww & t_cww;
    m[8] = wr & t_p0a;
    m[9] = rw & t_p0a;
    m[10] = rw & t_p1a & ~t_p0a & ~lf;
    m[11] = prw & t_cpred;
}

__device__ __forceinline__ uint32_t lane_of(const uint4 &v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

}  // namespace

__global__ void __launch_bounds__(NT)
lattice_masks_kernel(Planes a, long long nvec,
                     unsigned long long *__restrict__ out) {
    __shared__ unsigned long long part[NWARPS][NCLASS];
    unsigned long long best[NCLASS];
#pragma unroll
    for (int k = 0; k < NCLASS; ++k) best[k] = NONE;
    const long long stride = (long long)gridDim.x * NT;
    for (long long v = (long long)blockIdx.x * NT + threadIdx.x; v < nvec;
         v += stride) {
        uint4 pv[NPLANES], tv[NTPOSE];
#pragma unroll
        for (int i = 0; i < NPLANES; ++i) pv[i] = __ldg(a.p[i] + v);
#pragma unroll
        for (int i = 0; i < NTPOSE; ++i) tv[i] = __ldg(a.t[i] + v);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            uint32_t p[NPLANES], t[NTPOSE], m[NCLASS];
#pragma unroll
            for (int i = 0; i < NPLANES; ++i) p[i] = lane_of(pv[i], c);
#pragma unroll
            for (int i = 0; i < NTPOSE; ++i) t[i] = lane_of(tv[i], c);
            masks_of(p, t, m);
            const unsigned long long base =
                32ull * (unsigned long long)(4 * v + c);
#pragma unroll
            for (int k = 0; k < NCLASS; ++k)
                if (m[k] != 0u && best[k] == NONE)
                    best[k] = base + (unsigned long long)(__ffs(m[k]) - 1);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NCLASS; ++k) {
        unsigned long long x = best[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long y = __shfl_down_sync(FULL, x, off);
            x = y < x ? y : x;
        }
        if (lane == 0) part[warp][k] = x;
    }
    __syncthreads();
    if (threadIdx.x < NCLASS) {
        unsigned long long x = NONE;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) {
            const unsigned long long y = part[w][threadIdx.x];
            x = y < x ? y : x;
        }
        if (x != NONE) atomicMin(out + threadIdx.x, x);
    }
}

// planes: 8 pointers (ww, wr, rw, so_ww, so_wr, so_rw, so_rr, prw);
// tposes: 7 pointers (t_p0a, t_p1a, t_p0s, t_p1s, t_cww, t_cpred, t_lf);
// each an n_pad x n_pad / 32 plane of u32 words, contiguous, 16-byte
// aligned, on the card; out: u64[12] on the card. Sets out to all ones,
// then launches the pass. Returns the first cudaError (0 on success),
// cudaErrorInvalidValue for an n_pad that is not a positive multiple of
// 128 or a null or misaligned pointer.
extern "C" int lattice_masks_launch(const void *const *planes,
                                    const void *const *tposes, int n_pad,
                                    void *out, void *stream) {
    if (n_pad < 128 || n_pad % 128 != 0 || out == nullptr)
        return (int)cudaErrorInvalidValue;
    Planes a = {};
    for (int i = 0; i < NPLANES; ++i) {
        a.p[i] = (const uint4 *)planes[i];
        if (a.p[i] == nullptr || (uintptr_t)a.p[i] % 16 != 0)
            return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < NTPOSE; ++i) {
        a.t[i] = (const uint4 *)tposes[i];
        if (a.t[i] == nullptr || (uintptr_t)a.t[i] % 16 != 0)
            return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0xff,
                                      NCLASS * sizeof(unsigned long long), st);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    // n_pad * W words, W = n_pad / 32 a multiple of 4: whole uint4s
    const long long nvec = (long long)n_pad * (n_pad / 32) / 4;
    long long blocks = (nvec + NT - 1) / NT;
    if (blocks > (long long)sms * CTAS_PER_SM)
        blocks = (long long)sms * CTAS_PER_SM;
    lattice_masks_kernel<<<(int)blocks, NT, 0, st>>>(
        a, nvec, (unsigned long long *)out);
    return (int)cudaGetLastError();
}
