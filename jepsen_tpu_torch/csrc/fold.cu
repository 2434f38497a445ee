// The set algebra of the commutative checkers, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/fold.py::_kernels (:24, XLA programs, not
// Pallas): member_counts (:28), member (:36), set_kernel (:48),
// dup_kernel (:64) and multiset_minus_mask (:71). Each is one sort
// (jnp.sort, jnp.argsort) and binary searches (jnp.searchsorted) with
// compares. The sorts stay torch.sort in the wrapper (ops/fold.py); this
// kernel is the searches, the compares and the masks that follow.
//
// What it computes. Values are int64, or int32 where every value of the
// call fits (the wrapper narrows as the reference's _narrow does); ys
// arrays are ascending. lower(ys, x) is the first position whose value
// is not below x, upper(ys, x) the first above x, and member(ys, x) is
// lower(ys, x) < m && ys[lower] == x (false for an empty ys). Three
// modes, one thread an x:
//   SET   x0 = final_read (n0), x1 = adds (n1); y0, y1, y2 the sorted
//         attempts, final_read and adds. For x = x0[i]: mask0 (ok) =
//         member(y0, x), mask1 (unexpected) its negation, mask3
//         (recovered) = ok && !member(y2, x); for x = x1[j]: mask2 (lost)
//         = !member(y1, x). The set checker's four masks, one launch.
//   DUPS  x0 = xs, y0 = sorted xs: counts[i] = upper - lower, mask0[i] =
//         counts[i] > 1.
//   MINUS x0 = s, xs sorted stably, with order (int64) its permutation
//         of xs; y0 = sorted ys. The i-th sorted element is occurrence
//         i - lower(s, s[i]) of its value; it survives where that is at
//         least its count in ys: mask0[order[i]] = occurrence >= upper
//         (y0) - lower(y0), the keep-mask over xs in their own order.
//
// What bounds it on this card: memory. A search is ceil(log2(m + 1))
// dependent loads, the first levels shared by every thread and held in
// L1 and L2; each x is read once and each output written once, so the
// bound is those bytes over 3.35 TB/s. This first design is the simple
// one: one thread an x, the searches in global memory through L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { MODE_SET = 0, MODE_DUPS = 1, MODE_MINUS = 2 };
constexpr int NT = 256;

struct Args {
    const void *x0, *x1, *y0, *y1, *y2;
    const int64_t *order;
    uint8_t *mask0, *mask1, *mask2, *mask3;
    int64_t *counts;
    int64_t n0, n1, m0, m1, m2;
};

template <typename T>
__device__ __forceinline__ int64_t lower(const T *ys, int64_t m, T x) {
    int64_t lo = 0, hi = m;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (ys[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

template <typename T>
__device__ __forceinline__ int64_t upper(const T *ys, int64_t m, T x) {
    int64_t lo = 0, hi = m;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (ys[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

template <typename T>
__device__ __forceinline__ bool member(const T *ys, int64_t m, T x) {
    const int64_t lo = lower(ys, m, x);
    return lo < m && ys[lo] == x;
}

}  // namespace

template <typename T, int MODE>
__global__ void __launch_bounds__(NT) fold_member_kernel(Args a) {
    const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
    const T *x0 = (const T *)a.x0;
    const T *y0 = (const T *)a.y0;
    if (MODE == MODE_SET) {
        if (i < a.n0) {
            const T x = x0[i];
            const bool ok = member(y0, a.m0, x);
            a.mask0[i] = ok;
            a.mask1[i] = !ok;
            a.mask3[i] = ok && !member((const T *)a.y2, a.m2, x);
        } else if (i < a.n0 + a.n1) {
            const int64_t j = i - a.n0;
            a.mask2[j] = !member((const T *)a.y1, a.m1, ((const T *)a.x1)[j]);
        }
    } else if (MODE == MODE_DUPS) {
        if (i < a.n0) {
            const T x = x0[i];
            const int64_t c = upper(y0, a.m0, x) - lower(y0, a.m0, x);
            a.counts[i] = c;
            a.mask0[i] = c > 1;
        }
    } else {
        if (i < a.n0) {
            const T x = x0[i];
            const int64_t occurrence = i - lower(x0, a.n0, x);
            const int64_t cut = upper(y0, a.m0, x) - lower(y0, a.m0, x);
            a.mask0[a.order[i]] = occurrence >= cut;
        }
    }
}

template <typename T>
static int launch(int mode, const Args &a, cudaStream_t st) {
    const int64_t n = a.n0 + (mode == MODE_SET ? a.n1 : 0);
    const int64_t blocks = (n + NT - 1) / NT;
    if (n < 1 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (mode == MODE_SET)
        fold_member_kernel<T, MODE_SET><<<(unsigned)blocks, NT, 0, st>>>(a);
    else if (mode == MODE_DUPS)
        fold_member_kernel<T, MODE_DUPS><<<(unsigned)blocks, NT, 0, st>>>(a);
    else
        fold_member_kernel<T, MODE_MINUS><<<(unsigned)blocks, NT, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// mode: 0 SET, 1 DUPS, 2 MINUS (above); wide: 1 for int64 values, 0 for
// int32. ptrs: x0, x1, y0, y1, y2, order, mask0, mask1, mask2, mask3,
// counts (the ones a mode does not read may be null); lens: n0, n1, m0,
// m1, m2. Every array is contiguous on the card. Launches nothing and
// returns cudaErrorInvalidValue for an empty launch or an unknown mode;
// else the launch's cudaError (0 on success).
extern "C" int fold_member_launch(int mode, int wide,
                                  const void *const *ptrs,
                                  const int64_t *lens, void *stream) {
    if (mode < MODE_SET || mode > MODE_MINUS)
        return (int)cudaErrorInvalidValue;
    Args a;
    a.x0 = ptrs[0];
    a.x1 = ptrs[1];
    a.y0 = ptrs[2];
    a.y1 = ptrs[3];
    a.y2 = ptrs[4];
    a.order = (const int64_t *)ptrs[5];
    a.mask0 = (uint8_t *)ptrs[6];
    a.mask1 = (uint8_t *)ptrs[7];
    a.mask2 = (uint8_t *)ptrs[8];
    a.mask3 = (uint8_t *)ptrs[9];
    a.counts = (int64_t *)ptrs[10];
    a.n0 = lens[0];
    a.n1 = lens[1];
    a.m0 = lens[2];
    a.m1 = lens[3];
    a.m2 = lens[4];
    const cudaStream_t st = (cudaStream_t)stream;
    return wide ? launch<int64_t>(mode, a, st) : launch<int32_t>(mode, a, st);
}
