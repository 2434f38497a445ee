// SCC labels of a packed transitive closure, for Hopper (sm_90a).
//
// Replaces the labels of jepsen_tpu/ops/cycle.py::_kernels' scc (:64, an
// XLA program, not Pallas): over the closure R+ (paths of length >= 1),
//     both[i, j] = R+[i, j] & R+[j, i]  (| i == j),
//     label[i]   = min { j : both[i, j] },  diag[i] = R+[i, i],
// so that nodes of one strongly connected component share the least node
// of it as their label, and diag marks the nodes on a cycle. The closure
// itself is elle_pmm's (csrc/elle_pmm.cu, rounds of r | r.r to the
// fixpoint, ops/cycle.py).
//
// What it computes. R+ and T, its packed transpose (T[i, j] = R+[j, i]),
// are n_pad x n_pad boolean planes packed 32 columns a word (bit b of
// word w is column 32 w + b), W = n_pad / 32 words a row, n_pad a
// multiple of 128; then both[i, .] is row i of R+ AND row i of T, word by
// word. out is int32 [2, n_pad]: out[0][i] = label[i], out[1][i] = diag[i].
//
// Design: one warp a row. The warp reads the two rows 32 words at a time
// (coalesced 128-byte loads), ballots the lanes whose AND is not zero and
// stops at the first such chunk: its lowest lane's lowest bit is the least
// j. label = min(i, j), so no chunk that starts at or past column i is
// read.
//
// What bounds it on this card: memory. The function needs, of row i, the
// words of both planes up to the one holding its label's bit where the
// label is below i, else the ceil(i / 32) words of the columns below i
// (the strict lower triangle at most, n_pad^2 / 8 bytes over both
// planes), R+'s diagonal word, and 8 bytes written, over 3.35 TB/s. The
// kernel reads whole 32-word chunks, so a row reads up to 31 words more
// than that; a row whose component has a small least node stops early.

#include <cstdint>
#include <cuda_runtime.h>

static constexpr int NT = 256;       // 8 warps, 8 rows a CTA
static constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NT)
cycle_labels_kernel(const uint32_t *__restrict__ r,
                    const uint32_t *__restrict__ t, int n_pad,
                    int32_t *__restrict__ out) {
    const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n_pad) return;        // warp-uniform
    const int W = n_pad / 32;
    const uint32_t *ri = r + (size_t)row * W;
    const uint32_t *ti = t + (size_t)row * W;
    int label = row;
    for (int base = 0; base < W && base * 32 < row; base += 32) {
        const int w = base + lane;
        const uint32_t both = w < W ? ri[w] & ti[w] : 0u;
        const unsigned hit = __ballot_sync(FULL, both != 0u);
        if (hit) {
            const int first = __ffs(hit) - 1;
            const uint32_t word = __shfl_sync(FULL, both, first);
            label = min(row, (base + first) * 32 + __ffs(word) - 1);
            break;
        }
    }
    if (lane == 0) {
        out[row] = label;
        out[n_pad + row] = (ri[row >> 5] >> (row & 31)) & 1u;
    }
}

// r, t: the packed closure and its packed transpose, n_pad x n_pad / 32
// u32 words each, contiguous on the card; out: int32 [2, n_pad]. Returns
// the launch's cudaError (0 on success), cudaErrorInvalidValue for an
// n_pad that is not a positive multiple of 128.
extern "C" int cycle_labels_launch(const void *r, const void *t, int n_pad,
                                   void *out, void *stream) {
    if (n_pad < 128 || n_pad % 128 != 0 || r == nullptr || t == nullptr
        || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const int blocks = (n_pad + NT / 32 - 1) / (NT / 32);
    cycle_labels_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)r, (const uint32_t *)t, n_pad, (int32_t *)out);
    return (int)cudaGetLastError();
}
