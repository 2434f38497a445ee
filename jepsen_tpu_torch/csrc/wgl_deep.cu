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
// of 2^R / 32 words per row, so the word-split depths R = 15/16 need no
// separate arm: their split bits are ordinary word bits.
//
// Design.  One CTA walks one history at its own overlap depth; a batch
// is one grid and nothing carries between CTAs.  The TPU's sequential grid over event blocks
// becomes a loop inside the CTA that stages EB rows at a time into
// shared memory, with each new invoke's (a1, a2, t0) words gathered from
// the aux table while staging, so the per-row critical path reads shared
// memory only.  The plane lives in dynamic shared memory when it fits
// (up to 128 KB: R = 16 at SnP = 16, R = 15 at SnP = 32); at R = 16 with
// SnP = 32 it is 256 KB, more than a block may hold, and the same code
// runs on a global-memory plane the caller allocates (gplane).
//
// Bound.  Every closure round streams the plane once per open slot, and
// every row does at least one popcount pass; at R >= 12 the walk is
// bound by one SM's shared-memory bandwidth (128 B per clock), not by
// device memory: the event stream is a few bytes per row.  The design
// spreads each pass over the CTA's threads one word column per thread,
// so a warp touches 32 consecutive words of a row, and keeps every
// decision (fast path, fixpoint, death) in block-uniform values reduced
// through warp shuffles.
//
// Hazards.  Slot b's expansion moves configs from mask words lacking
// bit b to the words having it.  For b < 5 source and target are the
// same word and one thread owns it; for b >= 5 a thread reads column w
// (bit clear) and ORs into column w | d (bit set), which no thread reads
// in that pass.  The OR over state rows (the rank-1 move to t0) is taken
// over the column before the column is written.  Every pass ends with
// __syncthreads(), which also orders the global-memory plane.
#include <cstdint>
#include <cuda_runtime.h>

#define EB 512
#define FULL 0xFFFFFFFFu

// Invoke columns per event row of the wire (the reference's I; I = 2
// carries every depth, R = 1 with its second column empty).
constexpr int I = 2;

// Intra-word "lacks bit b" patterns: bit i set iff mask index i has bit
// b clear.
__constant__ uint32_t c_intra[5] = {0x55555555u, 0x33333333u,
                                    0x0F0F0F0Fu, 0x00FF00FFu,
                                    0x0000FFFFu};

__device__ __forceinline__ uint32_t lackpat(int b, int w) {
    if (b < 5) return c_intra[b];
    return ((w >> (b - 5)) & 1) ? 0u : FULL;
}

// Word index of the j-th column whose bit (b - 5) is clear.
__device__ __forceinline__ int clear_col(int j, int b) {
    const int k = b - 5;
    return ((j >> k) << (k + 1)) | (j & ((1 << k) - 1));
}

// Block-wide sums of two ints; every thread gets both totals.
__device__ __forceinline__ void block_sum2(int &x, int &y, int *red) {
    for (int o = 16; o; o >>= 1) {
        x += __shfl_down_sync(FULL, x, o);
        y += __shfl_down_sync(FULL, y, o);
    }
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[warp] = x;
        red[32 + warp] = y;
    }
    __syncthreads();
    x = 0;
    y = 0;
    for (int i = 0; i < nw; ++i) {
        x += red[i];
        y += red[32 + i];
    }
    __syncthreads();
}

// Lazy-retirement merge at (re)registration of slot sl: configs that
// differ only in the vacant bit are one config, so fold the bit-set half
// onto the bit-clear half.
__device__ __forceinline__ void merge_slot(uint32_t *fr, int sl, int SnP,
                                           int LNW) {
    const int NW = 1 << LNW, tid = threadIdx.x, nt = blockDim.x;
    if (sl < 5) {
        const uint32_t lp = c_intra[sl];
        const int sh = 1 << sl;
        for (int i = tid; i < SnP * NW; i += nt) {
            const uint32_t x = fr[i];
            fr[i] = (x & lp) | ((x & ~lp) >> sh);
        }
    } else {
        const int d = 1 << (sl - 5), hl = LNW - 1;
        for (int k = tid; k < (SnP << hl); k += nt) {
            uint32_t *row = fr + ((k >> hl) << LNW);
            const int w = clear_col(k & ((1 << hl) - 1), sl);
            row[w] |= row[w | d];
            row[w | d] = 0u;
        }
    }
}

// One slot's step of a Gauss-Seidel closure round toward the return of
// slot rs: linearize open slot b on every config lacking rs and b.
__device__ __forceinline__ void expand_slot(uint32_t *fr, int b, int rs,
                                            uint32_t a1b, uint32_t a2b,
                                            int t0b, int SnP, int LNW) {
    const int NW = 1 << LNW, tid = threadIdx.x, nt = blockDim.x;
    if (b < 5) {
        const uint32_t lpb = c_intra[b];
        const int sh = 1 << b;
        for (int w = tid; w < NW; w += nt) {
            const uint32_t m = lackpat(rs, w) & lpb;
            if (!m) continue;
            uint32_t red = 0u;
            for (int s = 0; s < SnP; ++s)
                if ((a2b >> s) & 1u) red |= fr[s * NW + w] & m;
            for (int s = 0; s < SnP; ++s) {
                const uint32_t x = fr[s * NW + w];
                uint32_t moved = ((a1b >> s) & 1u) ? (x & m) : 0u;
                if (s == t0b) moved |= red;
                fr[s * NW + w] = x | (moved << sh);
            }
        }
    } else {
        const int d = 1 << (b - 5);
        for (int j = tid; j < (NW >> 1); j += nt) {
            const int w = clear_col(j, b);
            const uint32_t m = lackpat(rs, w);
            if (!m) continue;
            uint32_t red = 0u;
            for (int s = 0; s < SnP; ++s)
                if ((a2b >> s) & 1u) red |= fr[s * NW + w] & m;
            for (int s = 0; s < SnP; ++s) {
                uint32_t moved = ((a1b >> s) & 1u) ? (fr[s * NW + w] & m)
                                                    : 0u;
                if (s == t0b) moved |= red;
                if (moved) fr[s * NW + (w | d)] |= moved;
            }
        }
    }
}

// cbuf: per history h, the compact wire at cbuf + offs[h] of nrows[h]
// rows: ret + 1 u8[L2] ++ islot + 1 u8[L2 * I] ++ iuop u16-LE[L2 * I].
// depth: i32[n], history h's overlap depth, 1 <= depth[h] <= R (R sizes
// the plane stride and the shared memory; a history walks its own
// 2^depth[h] masks, so one grid serves a batch of mixed depths).
// aux: diag-mask[UP] ++ const-mask[UP] ++ t0[UP] (u32).
// out: i32[n, 2] = (alive, first dead row | -1).
// work (nullable): i64[n], the plane words each history's passes touch.
__global__ void __launch_bounds__(1024)
wgl_deep_kernel(const uint8_t *__restrict__ cbuf,
                const int64_t *__restrict__ offs,
                const int32_t *__restrict__ nrows,
                const int32_t *__restrict__ depth,
                const uint32_t *__restrict__ aux, int UP, int R, int SnP,
                uint32_t *__restrict__ gplane,
                int32_t *__restrict__ out, long long *__restrict__ work) {
    extern __shared__ uint32_t smem[];
    __shared__ uint32_t a1r[32], a2r[32];
    __shared__ int t0r[32], openr[32];
    __shared__ int red[64];

    const int h = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int Rh = depth[h];
    if (Rh < 1 || Rh > R) __trap();     // the caller broke the contract
    const int LNW = Rh > 5 ? Rh - 5 : 0;
    const int PW = SnP << LNW;
    const int stride = SnP << (R > 5 ? R - 5 : 0);
    uint32_t *fr;
    int32_t *stage;
    if (gplane) {
        fr = gplane + (size_t)h * stride;
        stage = reinterpret_cast<int32_t *>(smem);
    } else {
        fr = smem;
        stage = reinterpret_cast<int32_t *>(smem + stride);
    }
    int32_t *s_ret = stage;
    int32_t *s_isl = s_ret + EB;
    uint32_t *s_a1 = reinterpret_cast<uint32_t *>(s_isl + EB * I);
    uint32_t *s_a2 = s_a1 + EB * I;
    int32_t *s_t0 = reinterpret_cast<int32_t *>(s_a2 + EB * I);

    // initial state is index 0 (interned first) at mask 0
    for (int i = tid; i < PW; i += nt) fr[i] = i == 0 ? 1u : 0u;
    if (tid < 32) {
        a1r[tid] = 0u;
        a2r[tid] = 0u;
        t0r[tid] = 0;
        openr[tid] = 0;
    }
    const int L2 = nrows[h];
    const uint8_t *c_ret = cbuf + offs[h];
    const uint8_t *c_isl = c_ret + L2;
    const uint8_t *c_iu = c_ret + (size_t)L2 * (1 + I);
    int dead = -1;
    long long words = 0;    // plane words the passes touch (bound model)
    __syncthreads();

    for (int g0 = 0; g0 < L2 && dead < 0; g0 += EB) {
        const int nb = min(EB, L2 - g0);
        for (int r = tid; r < nb; r += nt) s_ret[r] = (int)c_ret[g0 + r] - 1;
        for (int k = tid; k < nb * I; k += nt) {
            const size_t e = (size_t)g0 * I + k;
            const int sl = (int)c_isl[e] - 1;
            s_isl[k] = sl;
            if (sl >= 0) {
                const int u = (int)c_iu[2 * e] | ((int)c_iu[2 * e + 1] << 8);
                s_a1[k] = aux[u];
                s_a2[k] = aux[UP + u];
                s_t0[k] = (int)aux[2 * UP + u];
            }
        }
        __syncthreads();

        for (int r = 0; r < nb && dead < 0; ++r) {
            // register the row's new invokes
            for (int i = 0; i < I; ++i) {
                const int sl = s_isl[r * I + i];
                if (sl < 0) continue;
                if (tid == 0) {
                    a1r[sl] = s_a1[r * I + i];
                    a2r[sl] = s_a2[r * I + i];
                    t0r[sl] = s_t0[r * I + i];
                    openr[sl] = 1;
                }
                merge_slot(fr, sl, SnP, LNW);
                words += 2 * PW;
                __syncthreads();
            }
            const int rs = s_ret[r];
            if (rs < 0) continue;

            // a pure op legal on every config still lacking it is the
            // identity on the plane
            const uint32_t a1t = a1r[rs], a2t = a2r[rs];
            int n_lt = 0, n_ill = 0;
            for (int i = tid; i < PW; i += nt) {
                const uint32_t lt = fr[i] & lackpat(rs, i & ((1 << LNW) - 1));
                const int c = __popc(lt);
                n_lt += c;
                if (!((a1t >> (i >> LNW)) & 1u)) n_ill += c;
            }
            block_sum2(n_lt, n_ill, red);
            words += PW;
            if (!(a2t == 0u && n_ill == 0)) {
                int prev = -1, cnt = -1, lack = n_lt;
                bool prog = true;
                while (prog && lack > 0) {
                    for (int b = 0; b < Rh; ++b) {
                        if (!openr[b]) continue;
                        expand_slot(fr, b, rs, a1r[b], a2r[b], t0r[b], SnP,
                                    LNW);
                        words += b < 5 ? 2 * PW : PW;
                        __syncthreads();
                    }
                    int c = 0, l = 0;
                    for (int i = tid; i < PW; i += nt) {
                        const uint32_t x = fr[i];
                        c += __popc(x);
                        l += __popc(x & lackpat(rs, i & ((1 << LNW) - 1)));
                    }
                    block_sum2(c, l, red);
                    words += PW;
                    prog = c > prev;
                    prev = c;
                    cnt = c;
                    lack = l;
                }
                // prune configs that never linearized rs (the bit stays
                // set: lazy retirement)
                for (int i = tid; i < PW; i += nt)
                    fr[i] &= ~lackpat(rs, i & ((1 << LNW) - 1));
                words += 2 * PW;
                if (cnt >= 0 && cnt == lack) dead = g0 + r;
            }
            if (tid == 0) openr[rs] = 0;
            __syncthreads();
        }
        __syncthreads();
    }
    if (tid == 0) {
        out[2 * h] = dead < 0 ? 1 : 0;
        out[2 * h + 1] = dead;
        if (work) work[h] = words;
    }
}

// Launches one grid of n_hist CTAs on `stream`; returns the launch's
// cudaError_t (0 on success).  smem_bytes is the dynamic shared memory
// the caller sized: the staged event block, plus the plane when gplane
// is null.
extern "C" int wgl_deep_launch(const void *cbuf, const void *offs,
                               const void *nrows, const void *depth,
                               const void *aux, int UP,
                               int n_hist, int R, int SnP,
                               void *gplane, void *out, void *work,
                               int threads,
                               int smem_bytes, void *stream) {
    cudaError_t err = cudaFuncSetAttribute(
        wgl_deep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    wgl_deep_kernel<<<n_hist, threads, smem_bytes,
                      (cudaStream_t)stream>>>(
        (const uint8_t *)cbuf, (const int64_t *)offs,
        (const int32_t *)nrows, (const int32_t *)depth,
        (const uint32_t *)aux, UP, R, SnP,
        (uint32_t *)gplane, (int32_t *)out, (long long *)work);
    return (int)cudaGetLastError();
}
