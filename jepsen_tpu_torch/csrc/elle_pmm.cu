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
// stored) and x may be null.  One launch runs up to MAX_JOBS jobs, all
// reading their inputs as they were before the launch: the round of
// elle_mesh.py:362-364 is three jobs,
//     cww' = cww | cww.cww,  p0' = p0 | p0.p0,  p1' = p1 | q.p1 | p1.q,
// written to new planes (Jacobi: the reference's while_loop computes a
// round from the old triple, and the round count is part of the verdict).
// `changed`, when given, is set to 1 if any job's out differs from its x
// anywhere; the wrapper zeroes it before the launch.
//
// Two kernels, launched in turn on one stream.  elle_tile_bits counts
// the set bits of each TILE-row tile of each left operand (a0 | a1 as
// one) and of its densest row, and writes the packed transposes of the
// right planes (b0, b1).  elle_pmm_kernel then decides, for each (job,
// row tile), one of two forms from those counts and the constant
// GATHER_NUM / GATHER_DEN, and computes the dense tiles first and the
// gather rows after, in one persistent grid (one CTA of 384 threads an
// SM).
//
// Dense form, on the int8 tensor cores.  A 0/1 product is exact in
// s8 x s8 -> s32 (a job's count is at most 2 n_pad < 2^31) and the
// threshold is > 0.  The CTAs walk output tiles of BM = TILE rows x BN =
// 256 columns (8 words; the last column tile of a row may be half past
// W: its B rows are zeros and nothing is stored there) round-robin.
// The producer warpgroup copies each chunk of KC = 128 k bits as packed
// words (A rows a0, a1; rows of B's transposes b0t, b1t: B's columns
// with their k bits along the row) into a ring DEPTH chunks ahead with
// cp.async, then unpacks both into s8 tiles in shared memory, K-major as
// wgmma wants 8-bit operands: byte 4 i + b of a 32-bit k group holds bit
// i + 8 b (one permutation of k on both operands, so the sum is
// unchanged; a shift and a mask a four bytes).  A chunk of 128 k is one
// 128-byte swizzle row, stored with the 128-byte swizzle that the
// descriptors name; fence.proxy.async makes the stores visible to wgmma
// before the full barrier's arrive.  Each consumer warpgroup runs
// wgmma.mma_async.m64n256k32.s32.s8.s8 on its 64 rows, four k steps a
// chunk, one wgmma group in flight, both terms of a job into one
// accumulator (128 registers); the epilogue packs a row's 32 columns
// from a quad of lanes with two shuffles, ORs in x, sets the flag and
// stores.  STAGES = 4 unpacked chunks (48 KB each) and the ring (12 KB a
// chunk): 218 KB of dynamic shared memory and a byte of form a (job,
// row tile).  No dense plane is ever in device memory.
//
// Row-gather form, for sparse row tiles. After its dense tiles every
// consumer warp of the grid takes gather rows round-robin: lanes across
// the row's W words (GW a lane in registers), it loads the row's A words
// of each term, and each step takes the lowest set bit of up to GB lanes'
// words (a ballot and a shuffle) and ORs those rows of B into the row:
// one coalesced word OR a set bit and word, B read from L2, every load
// unconditional so that a step's GB x GW loads are in flight together (a
// guarded load compiles to a branch of its own, and those go out one at a
// time). A row whose operands' rows hold more than PIECE_BITS set bits is
// split by k among several warps (ORed with atomicOr into the zeroed
// output), so one dense row is no serial tail.
//
// What bounds it on this card. Dense: 2 n_pad^2 r int8 operations a
// product (r rows) at 1,979 TOP/s. Beside the tensor cores the producer
// unpacks 12 words a thread and chunk, and shared memory carries its 48
// KB, the ring's 24 KB and wgmma's 80 KB of operand reads a chunk.
// elle_pmm_variants.py times this source beside copies without the
// products or without the unpacking in one call: each alone takes about
// three quarters of the whole, so the dense form is held by the unpacking
// and the products sharing the SM. What the design does about it: B is
// transposed once a round (elle_tile_bits), not once for each of the 79
// row tiles that read it; one m64n256 instruction a warpgroup reads 20 KB
// of operands a k step where two m64n128 of a 256 x 128 tile read 24 KB;
// four stages. setmaxnreg was tried and dropped (its variant there):
// ptxas allocates every warp at the entry limit, 168 registers a thread
// at 384 threads, so raising the consumers gave them nothing and capping
// the producer made the round slower; a second producer warpgroup (512
// threads, 128 registers a thread) serialized the wgmma and spilled.
// Gather: one word OR (4 bytes from L2) for each set bit and word, so its
// time follows the set bits; the packed bytes (each plane read once, each
// output written once, n_pad^2 / 8 a plane) bound a sparse round.
//
// Crossover.  A (job, row tile) takes the gather form when its left
// operands' set bits, summed over the job's terms, are at most
//     nterms x TILE x n_pad x GATHER_NUM / GATHER_DEN,
// else the dense form.  A dense tile costs the same whatever its bits,
// a gather tile in proportion to them, so the crossover is a density:
// the dense form's time a term-tile over the gather form's time a set
// bit and TILE x n_pad.  chip_smoke.py's [elle-kernel] crossover line
// measures both at n_pad 10,112 (a round of half-set planes, 316
// term-tiles dense; rounds of 1.0 M to 5.1 M set bits gathered) and
// prints the density they give: on an NVIDIA H100 80GB HBM3 at 700 W,
// 22.312 us a term-tile over 0.2100 ns a set bit and 1,294,336 bits is
// 8.2%; other calls gave 7.8% to 11.8% as the gathered rounds' fit
// moved.  Taken as 2 / 25.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_JOBS = 4;
constexpr int MAX_TERMS = 2;
constexpr int MAX_OPS = MAX_JOBS * MAX_TERMS;
constexpr int MAX_PLANES = 2 * MAX_OPS;   // right planes to transpose
constexpr int TILE = 128;         // rows of a counted tile
constexpr int BM = TILE;          // rows of a dense output tile (128)
constexpr int BN = 256;           // columns of a dense output tile
constexpr int BNW = BN / 32;      // words of a dense output tile (8)
constexpr int KC = 128;           // bits of k a staged chunk
constexpr int STAGES = 4;
constexpr int NT = 384;           // 2 consumer warpgroups, 1 producer
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * KC;              // 16 KB
constexpr int B_BYTES = BN * KC;              // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// The producer's ring of packed chunks (cp.async, DEPTH chunks ahead):
// a0, a1 (BM rows x 16 bytes each), b0t, b1t (BN rows x 16 bytes).
constexpr int DEPTH = 2;
constexpr int PACK_A = BM * 16, PACK_B = BN * 16;
constexpr int PACK_BYTES = 2 * PACK_A + 2 * PACK_B;   // 12 KB
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + DEPTH * PACK_BYTES
                           + 2 * STAGES * 8;
constexpr int GW = 10;            // gather: words a lane holds (320 a pass)
constexpr int GB = 2;             // gather: set bits a step
// A gather row whose left operands' rows hold more than PIECE_BITS set
// bits (summed over the terms) is split by k into up to MAX_PIECES
// pieces, each a warp's, ORed into the output with atomicOr: a warp
// walks GB bits a step, so one dense row alone would be a serial tail.
constexpr int PIECE_BITS = 128;
constexpr int MAX_PIECES = 64;
constexpr unsigned FULL = 0xffffffffu;

// Crossover of the two forms (see the note above), a density: a tile
// whose bits are at most this share of its TILE x n_pad bits (each term)
// is gathered.
constexpr long long GATHER_NUM = 2;
constexpr long long GATHER_DEN = 25;

struct Term {
    const uint32_t *a0, *a1, *b0, *b1;
    const uint32_t *b0t, *b1t;    // the packed transposes of b0, b1
};

struct Job {
    const uint32_t *x;
    uint32_t *out;
    Term t[MAX_TERMS];
    int op[MAX_TERMS];    // the row of each term's left operand in counts
    int nterms;
    int slot;             // the job's index in the caller's order
};

struct Jobs {
    Job j[MAX_JOBS];      // two-term jobs first (they are the longest)
    int njobs;
};

struct Ops {
    const uint32_t *a0[MAX_OPS], *a1[MAX_OPS];
    const uint32_t *src[MAX_PLANES];
    uint32_t *dst[MAX_PLANES];
};

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// Waits for the phase of the given parity to complete.  A protocol fault
// traps after about ten seconds rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    while (true) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > 20000000000LL) __trap();
    }
}

// A K-major operand of 128-byte rows with the 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO), LBO unused, base 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator
// across the asynchronous wgmma.
__device__ __forceinline__ void fence_acc(int (&d)[BN / 2]) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
        asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 256 s32, the wgmma fragment) += A (64 x 32 s8) . B (32 x 256).
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[BN / 2],
                                                 uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
        "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
        "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "%128, %129, p;\n}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

// Lane p gets the word whose bit l is bit p of lane l's x: a 32 x 32 bit
// transpose across the warp, one stage a bit of the lane index (stage j
// swaps the elements whose row and column differ in bit j): a shuffle, a
// rotate and a bit select a stage.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
    for (int j = 16; j >= 1; j >>= 1) {
        const uint32_t m = j == 16 ? 0x0000FFFFu : j == 8 ? 0x00FF00FFu
                         : j == 4 ? 0x0F0F0F0Fu : j == 2 ? 0x33333333u
                         : 0x55555555u;
        const uint32_t y = __shfl_xor_sync(FULL, x, j);
        // the lower lane takes y's bits b - j into its bits b with bit j
        // set, the upper lane y's bits b + j into those with bit j clear
        const bool hi = lane & j;
        const uint32_t t = __funnelshift_l(y, y, hi ? 32 - j : j);
        const uint32_t keep = hi ? ~m : m;
        x = (x & keep) | (t & ~keep);
    }
    return x;
}

// The 32 bits of x as 32 s8 bytes 0/1 at dst's two swizzled 16-byte
// chunks c0, c1 of one row: byte 4 i + b of the group holds bit i + 8 b.
__device__ __forceinline__ void put_bytes(uint8_t *row, int c0, int c1,
                                          uint32_t x) {
    uint4 lo, hi;
    lo.x = x & 0x01010101u;
    lo.y = (x >> 1) & 0x01010101u;
    lo.z = (x >> 2) & 0x01010101u;
    lo.w = (x >> 3) & 0x01010101u;
    hi.x = (x >> 4) & 0x01010101u;
    hi.y = (x >> 5) & 0x01010101u;
    hi.z = (x >> 6) & 0x01010101u;
    hi.w = (x >> 7) & 0x01010101u;
    *reinterpret_cast<uint4 *>(row + (c0 << 4)) = lo;
    *reinterpret_cast<uint4 *>(row + (c1 << 4)) = hi;
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

__device__ __forceinline__ uint4 ld4(const uint32_t *p) {
    return __ldg(reinterpret_cast<const uint4 *>(p));
}

// 16 bytes from global memory to shared memory, asynchronously; the
// bytes past `bytes` (0 or 16) are zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void *src,
                                     int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds4(const uint8_t *p) {
    return *reinterpret_cast<const uint4 *>(p);
}

// The form of (job, row tile t): 0 dense, else the pieces a gather row
// of it is split into.  counts[2 (op tiles + t)] holds an operand tile's
// set bits, the next int the most in one of its rows.
__device__ __forceinline__ int tile_form(const Job &job, const int *counts,
                                         int tiles, int t, int n_pad) {
    long long bits = 0;
    int row = 0;
    for (int u = 0; u < job.nterms; ++u) {
        const int *c = counts + 2 * (job.op[u] * tiles + t);
        bits += c[0];
        row += c[1];
    }
    if (bits * GATHER_DEN > (long long)job.nterms * TILE * n_pad * GATHER_NUM)
        return 0;
    const int most = min(MAX_PIECES, n_pad / 32);
    return max(1, min(most, (row + PIECE_BITS - 1) / PIECE_BITS));
}

struct Item {
    int job, i0, w0;
    bool dense;       // the item's row tile takes the dense form
};

// The dense items, in the order every role of every CTA walks them:
// jobs in Jobs order, then row blocks, then column tiles.
// form[j * tiles + t] is tile_form of (job j, row tile t).
__device__ __forceinline__ Item item_at(const uint8_t *form, int item,
                                        int n_pad, int W) {
    const int cts = (W + BNW - 1) / BNW, tiles = n_pad / TILE;
    Item it;
    it.job = item / (tiles * cts);
    const int rest = item - it.job * tiles * cts;
    const int t = rest / cts;
    it.i0 = t * BM;
    it.w0 = (rest - t * cts) * BNW;
    it.dense = form[it.job * tiles + t] == 0;
    return it;
}

// The producer's position in the chunk sequence: a dense item and a
// chunk of it (term c / kch, k words (c % kch) * 4).
struct Cursor {
    Item im;
    int item, c, nch;
};

// The first dense item at or after `item`, stepping gridDim.x.
__device__ __forceinline__ bool seek(Cursor &cu, const Jobs &jobs,
                                     const uint8_t *form, int item,
                                     int items, int n_pad, int W, int kch) {
    for (; item < items; item += gridDim.x) {
        cu.im = item_at(form, item, n_pad, W);
        if (cu.im.dense) {
            cu.item = item;
            cu.c = 0;
            cu.nch = jobs.j[cu.im.job].nterms * kch;
            return true;
        }
    }
    cu.item = items;
    return false;
}

// One chunk's packed rows into a ring slot: producer thread pt copies A
// row i0 + pt and rows n0 + pt and n0 + pt + 128 of B's transpose (zeros
// past n_pad), each the chunk's 4 words.
__device__ __forceinline__ void fetch(const Cursor &cu, const Jobs &jobs,
                                      int kch, int n_pad, int W, int pt,
                                      uint32_t slot) {
    const Job &job = jobs.j[cu.im.job];
    const int u = cu.c / kch;
    const int kw = (cu.c - u * kch) * (KC / 32);
    const Term tm = job.t[u];
    const size_t at = (size_t)(cu.im.i0 + pt) * W + kw;
    cp16(slot + 16 * pt, tm.a0 + at, 16);
    cp16(slot + PACK_A + 16 * pt, tm.a1 != nullptr ? tm.a1 + at : tm.a0,
         tm.a1 != nullptr ? 16 : 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = pt + 128 * h;
        const int n = cu.im.w0 * 32 + r;
        const size_t bt = n < n_pad ? (size_t)n * W + kw : 0;
        cp16(slot + 2 * PACK_A + 16 * r, tm.b0t + bt, n < n_pad ? 16 : 0);
        cp16(slot + 2 * PACK_A + PACK_B + 16 * r,
             tm.b1t != nullptr ? tm.b1t + bt : tm.b0t,
             n < n_pad && tm.b1t != nullptr ? 16 : 0);
    }
}

// One term of a gather row: acc |= (A row i) . B over the row's set
// bits in A words [lo, hi), GB bits a step (the lowest set bit of up to
// GB lanes' A words).
// Every load is issued unconditionally (a column past W reads word W - 1
// into a word that is never stored; a missing bit repeats the step's
// first), so a step's GB x GW loads are in flight together.
template <bool B1>
__device__ __forceinline__ void gather_term(const Term &tm, int i, int W,
                                            int lo, int hi, int wc, int lane,
                                            uint32_t (&acc)[GW]) {
    int col[GW];
#pragma unroll
    for (int g = 0; g < GW; ++g) col[g] = min(wc + 32 * g + lane, W - 1);
    for (int s0 = lo; s0 < hi; s0 += 32 * GW) {
        uint32_t aw[GW];
#pragma unroll
        for (int g = 0; g < GW; ++g) {
            const int w = s0 + 32 * g + lane;
            aw[g] = 0u;
            if (w < hi) {
                aw[g] = __ldg(tm.a0 + (size_t)i * W + w);
                if (tm.a1 != nullptr)
                    aw[g] |= __ldg(tm.a1 + (size_t)i * W + w);
            }
        }
#pragma unroll
        for (int g0 = 0; g0 < GW; ++g0) {
            if (s0 + 32 * g0 >= hi) break;
            uint32_t a = aw[g0];
            uint32_t m = __ballot_sync(FULL, a != 0u);
            while (m) {
                const int myk = (s0 + 32 * g0 + lane) * 32 + __ffs(a) - 1;
                int k[GB];
                uint32_t took = 0u;
#pragma unroll
                for (int q = 0; q < GB; ++q) {
                    const int src = m != 0u ? __ffs(m) - 1 : __ffs(took) - 1;
                    took |= 1u << src;
                    m &= m - 1;
                    k[q] = __shfl_sync(FULL, myk, src);
                }
                if (took >> lane & 1u) a &= a - 1;
                uint32_t v[GB][GW];
#pragma unroll
                for (int q = 0; q < GB; ++q) {
                    const uint32_t *r0 = tm.b0 + (size_t)k[q] * W;
#pragma unroll
                    for (int g = 0; g < GW; ++g) v[q][g] = __ldg(r0 + col[g]);
                }
                if (B1) {
#pragma unroll
                    for (int q = 0; q < GB; ++q) {
                        const uint32_t *r1 = tm.b1 + (size_t)k[q] * W;
#pragma unroll
                        for (int g = 0; g < GW; ++g)
                            v[q][g] |= __ldg(r1 + col[g]);
                    }
                }
#pragma unroll
                for (int q = 0; q < GB; ++q)
#pragma unroll
                    for (int g = 0; g < GW; ++g) acc[g] |= v[q][g];
                m = __ballot_sync(FULL, a != 0u);
            }
        }
    }
}

// Piece `piece` of `pieces` of row i of a gather tile, by one warp:
// lanes across the words (GW a lane, passes of 32 GW words), the piece's
// share of A's words.  A whole row (one piece) is stored; a piece ORs
// its words, x's with the first, into the zeroed output.
__device__ __forceinline__ void gather_row(const Job &job, int i, int W,
                                           int piece, int pieces, int lane,
                                           bool &diff) {
    const int lo = piece * W / pieces, hi = (piece + 1) * W / pieces;
    const bool whole = pieces == 1;
    for (int wc = 0; wc < W; wc += 32 * GW) {
        uint32_t acc[GW], old[GW];
#pragma unroll
        for (int g = 0; g < GW; ++g) {
            const int w = wc + 32 * g + lane;
            old[g] = (job.x != nullptr && w < W && (whole || piece == 0))
                         ? job.x[(size_t)i * W + w] : 0u;
            acc[g] = whole ? old[g] : 0u;
        }
        for (int u = 0; u < job.nterms; ++u) {
            const Term tm = job.t[u];
            if (tm.b1 != nullptr)
                gather_term<true>(tm, i, W, lo, hi, wc, lane, acc);
            else
                gather_term<false>(tm, i, W, lo, hi, wc, lane, acc);
        }
#pragma unroll
        for (int g = 0; g < GW; ++g) {
            const int w = wc + 32 * g + lane;
            if (w >= W) continue;
            uint32_t *o = job.out + (size_t)i * W + w;
            if (whole) {
                *o = acc[g];
                diff |= acc[g] != old[g];
            } else if ((acc[g] | old[g]) != 0u) {
                // x is read here only where the piece found bits
                const uint32_t x = (piece == 0 || job.x == nullptr)
                                       ? old[g] : job.x[(size_t)i * W + w];
                atomicOr(o, acc[g] | old[g]);
                diff |= (acc[g] & ~x) != 0u;
            }
        }
    }
}

// A consumer warpgroup's epilogue for its 64 rows: threshold, pack a
// row's 32 columns from a quad of lanes, OR in x, store (the quad's lane
// q keeps words q and q + 4 of the row's 8; none past W).
__device__ __forceinline__ void epilogue(const int (&d)[BN / 2],
                                         const Job &job, int row0, int w0,
                                         int W, int lane, bool &diff) {
    const int quad = lane & 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        uint32_t mine[BNW / 4] = {};
#pragma unroll
        for (int q = 0; q < BNW; ++q) {
            uint32_t bits = 0u;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int b = 0; b < 2; ++b)
                    bits |= (d[4 * (4 * q + jj) + 2 * e + b] > 0 ? 1u : 0u)
                            << (8 * jj + 2 * quad + b);
            bits |= __shfl_xor_sync(FULL, bits, 1);
            bits |= __shfl_xor_sync(FULL, bits, 2);
            if (quad == q % 4) mine[q / 4] = bits;
        }
        const int i = row0 + (lane >> 2) + 8 * e;
#pragma unroll
        for (int m = 0; m < BNW / 4; ++m) {
            const int w = w0 + quad + 4 * m;
            if (w >= W) continue;
            const size_t at = (size_t)i * W + w;
            const uint32_t old = job.x != nullptr ? job.x[at] : 0u;
            const uint32_t v = old | mine[m];
            job.out[at] = v;
            diff |= v != old;
        }
    }
}

}  // namespace

// A round's first launch.  Blocks [0, nops tiles) count: the set bits of
// each TILE-row tile of each operand (a0 | a1), and the most in one of
// its rows, into counts[2 (op tiles + tile)] and the next int; a warp a
// row at a time.  The blocks after them transpose the right planes
// src[p] into dst[p] (packed: bit a of dst row b is bit b of src row a),
// 256 rows x 4 words of src a block: each warp turns 32 rows into 32
// columns of 4 words (transpose32), staged in shared memory so that the
// block writes 128 rows of 8 words.
template <int TR>
__global__ void __launch_bounds__(256)
elle_tile_bits(const Ops ops, int nops, int n_pad, int *counts) {
    const int W = n_pad / 32, tiles = n_pad / TR;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int b = blockIdx.x;
    if (b < nops * tiles) {
        const int o = b / tiles, t = b - o * tiles;
        int sum = 0, most = 0;
        for (int r = warp; r < TR; r += 8) {
            const size_t base = ((size_t)t * TR + r) * W;
            const uint32_t *a0 = ops.a0[o] + base;
            const uint32_t *a1 =
                ops.a1[o] == nullptr ? nullptr : ops.a1[o] + base;
            int row = 0;
            for (int idx = lane; idx < W / 4; idx += 32) {
                uint4 v = ld4(a0 + 4 * idx);
                if (a1 != nullptr) v = or4(v, ld4(a1 + 4 * idx));
                row += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
            }
            row = __reduce_add_sync(FULL, row);
            sum += row;
            most = max(most, row);
        }
        __shared__ int part[2][8];
        if (lane == 0) {
            part[0][warp] = sum;
            part[1][warp] = most;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            int s = 0, m = 0;
            for (int w = 0; w < 8; ++w) {
                s += part[0][w];
                m = max(m, part[1][w]);
            }
            counts[2 * b] = s;
            counts[2 * b + 1] = m;
        }
        return;
    }
    b -= nops * tiles;
    const int cbs = W / 4, rbs = (n_pad + 255) / 256;
    const int p = b / (rbs * cbs);
    b -= p * rbs * cbs;
    const int rb = b / cbs, cb = b - rb * cbs;
    const int r = 256 * rb + 32 * warp + lane;
    const uint4 v = r < n_pad ? ld4(ops.src[p] + (size_t)r * W + 4 * cb)
                              : make_uint4(0u, 0u, 0u, 0u);
    __shared__ uint32_t tt[128][9];
    // lane l of column group j: column 128 cb + 32 j + l's bits over
    // rows 256 rb + 32 warp .. + 31, word 8 rb + warp of its dst row
    tt[lane][warp] = transpose32(v.x, lane);
    tt[32 + lane][warp] = transpose32(v.y, lane);
    tt[64 + lane][warp] = transpose32(v.z, lane);
    tt[96 + lane][warp] = transpose32(v.w, lane);
    __syncthreads();
    const int n = threadIdx.x >> 1, h = threadIdx.x & 1;
    const int wd = 8 * rb + 4 * h;
    if (wd < W)
        *reinterpret_cast<uint4 *>(ops.dst[p] + (size_t)(128 * cb + n) * W
                                   + wd) =
            make_uint4(tt[n][4 * h], tt[n][4 * h + 1], tt[n][4 * h + 2],
                       tt[n][4 * h + 3]);
}

// The product.  Persistent: gridDim.x CTAs (one an SM) walk the dense
// items round-robin, then every consumer warp of the grid takes the
// gather rows round-robin.  Each CTA first decides every (job, row tile)
// from the counts into shared memory; CTA 0 also writes them to forms
// (forms[slot * tiles + t]: 1 dense, 0 gather).
template <int M, int N, int S>
__global__ void __launch_bounds__(NT, 1)
elle_pmm_kernel(const Jobs jobs, int n_pad, const int *counts, int *forms,
                int *changed) {
    static_assert(M == BM && N == BN && S == STAGES, "one instantiation");
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t *smem = smem_raw + (base - raw);
    const uint32_t bars = base + STAGES * STAGE_BYTES
                          + DEPTH * PACK_BYTES;   // full, then empty
    uint8_t *form = smem + STAGES * STAGE_BYTES + DEPTH * PACK_BYTES
                    + 2 * STAGES * 8;             // [njobs, tiles]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int W = n_pad / 32;
    const int tiles = n_pad / TILE;
    const int kch = n_pad / KC;
    const int items = jobs.njobs * tiles * ((W + BNW - 1) / BNW);

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bars + 8 * s, 128);                 // producer threads
            mbar_init(bars + 8 * (STAGES + s), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int f = tid; f < jobs.njobs * tiles; f += NT)
        form[f] = tile_form(jobs.j[f / tiles], counts, tiles, f % tiles,
                            n_pad);
    __syncthreads();
    if (blockIdx.x == 0 && forms != nullptr)
        for (int f = tid; f < jobs.njobs * tiles; f += NT)
            forms[jobs.j[f / tiles].slot * tiles + f % tiles] = form[f] == 0;

    if (warp >= CONSUMER_WARPS) {
        // ---- producer: unpack the chunks into the stages ----
        const int pt = tid & 127;
        const uint32_t ring = base + STAGES * STAGE_BYTES;
        const uint8_t *ring_p = smem + STAGES * STAGE_BYTES;
        Cursor lc, uc;              // the next chunk to fetch, to unpack
        bool lok = seek(lc, jobs, form, blockIdx.x, items, n_pad, W, kch);
        bool uok = lok;
        uc = lc;
#pragma unroll 1
        for (int d = 0; d < DEPTH; ++d) {
            if (lok) {
                fetch(lc, jobs, kch, n_pad, W, pt, ring + d * PACK_BYTES);
                if (++lc.c == lc.nch)
                    lok = seek(lc, jobs, form, lc.item + gridDim.x, items,
                               n_pad, W, kch);
            }
            cp_commit();
        }
        for (int it = 0; uok; ++it) {
            const int slot = it % DEPTH;
            const int s = it % STAGES;
            cp_wait<DEPTH - 1>();                     // chunk it has landed
            const uint8_t *pk = ring_p + slot * PACK_BYTES;
            uint8_t *as = smem + s * STAGE_BYTES;
            const uint4 a = or4(lds4(pk + 16 * pt),
                                lds4(pk + PACK_A + 16 * pt));
            // columns n0 + pt and n0 + pt + 128: their k bits, as B's
            // transpose holds them
            uint4 b[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
                b[h] = or4(lds4(pk + 2 * PACK_A + 16 * (pt + 128 * h)),
                           lds4(pk + 2 * PACK_A + PACK_B
                                + 16 * (pt + 128 * h)));
            mbar_wait(bars + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
            const int sw = pt & 7;                // (pt + 128) & 7 too
            {
                uint8_t *row = as + pt * KC;
                put_bytes(row, 0 ^ sw, 1 ^ sw, a.x);
                put_bytes(row, 2 ^ sw, 3 ^ sw, a.y);
                put_bytes(row, 4 ^ sw, 5 ^ sw, a.z);
                put_bytes(row, 6 ^ sw, 7 ^ sw, a.w);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint8_t *row = as + A_BYTES + (pt + 128 * h) * KC;
                put_bytes(row, 0 ^ sw, 1 ^ sw, b[h].x);
                put_bytes(row, 2 ^ sw, 3 ^ sw, b[h].y);
                put_bytes(row, 4 ^ sw, 5 ^ sw, b[h].z);
                put_bytes(row, 6 ^ sw, 7 ^ sw, b[h].w);
            }
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_arrive(bars + 8 * s);
            // the slot's words are in registers now: refill it
            if (lok) {
                fetch(lc, jobs, kch, n_pad, W, pt, ring + slot * PACK_BYTES);
                if (++lc.c == lc.nch)
                    lok = seek(lc, jobs, form, lc.item + gridDim.x, items,
                               n_pad, W, kch);
            }
            cp_commit();
            if (++uc.c == uc.nch)
                uok = seek(uc, jobs, form, uc.item + gridDim.x, items,
                           n_pad, W, kch);
        }
    } else {
        // ---- consumers: wgmma on the stages, then the gather rows ----
        const int g = warp >> 2;                      // warpgroup 0 / 1
        bool diff = false;
        int it = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const Item im = item_at(form, item, n_pad, W);
            if (!im.dense) continue;
            const Job &job = jobs.j[im.job];
            const int nch = job.nterms * kch;
            int d[BN / 2];
#pragma unroll
            for (int q = 0; q < BN / 2; ++q) d[q] = 0;
            int prev = -1;
            for (int c = 0; c < nch; ++c, ++it) {
                const int s = it % STAGES;
                mbar_wait(bars + 8 * s, (it / STAGES) & 1);
                const uint32_t as = base + s * STAGE_BYTES;
                const uint64_t da = smem_desc(as + 64 * g * KC);
                const uint64_t db = smem_desc(as + A_BYTES);
                fence_acc(d);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < KC / 32; ++kk)
                    wgmma_m64n256k32(d, da + 2 * kk, db + 2 * kk);
                wgmma_commit();
                wgmma_wait<1>();
                fence_acc(d);
                if (prev >= 0 && lane == 0)
                    mbar_arrive(bars + 8 * (STAGES + prev));
                prev = s;
            }
            wgmma_wait<0>();
            fence_acc(d);
            if (lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
            epilogue(d, job, im.i0 + 64 * g + 16 * (warp & 3), im.w0, W,
                     lane, diff);
        }

        const int nw = gridDim.x * CONSUMER_WARPS;
        const int gw = blockIdx.x * CONSUMER_WARPS + warp;
        int first = 0;                  // gather pieces before this tile
        for (int j = 0; j < jobs.njobs; ++j) {
            const Job &job = jobs.j[j];
            for (int t = 0; t < tiles; ++t) {
                const int pieces = form[j * tiles + t];
                if (pieces == 0) continue;
                for (int r = ((gw - first) % nw + nw) % nw;
                     r < TILE * pieces; r += nw)
                    gather_row(job, t * TILE + r / pieces, W, r % pieces,
                               pieces, lane, diff);
                first = (first + TILE * pieces) % nw;
            }
        }
        if (__any_sync(FULL, diff) && lane == 0 && changed != nullptr)
            *changed = 1;
    }
}

extern "C" int elle_pmm_smem(int n_pad);

// ops holds two pointers an operand, a0 and a1 (a1 may be null); counts
// is int32[nops, n_pad / TILE, 2] on the device; planes holds two
// pointers a right plane to transpose, the plane and its transpose's
// buffer.  Returns the launch's cudaError (0 on success).
extern "C" int elle_tile_bits_launch(const void *const *ops, int nops,
                                     void *const *planes, int nplanes,
                                     int n_pad, void *counts, void *stream) {
    if (nops < 1 || nops > MAX_OPS || nplanes < 0 || nplanes > MAX_PLANES
        || n_pad < TILE || n_pad % TILE != 0)
        return (int)cudaErrorInvalidValue;
    Ops o = {};
    for (int i = 0; i < nops; ++i) {
        o.a0[i] = (const uint32_t *)ops[2 * i];
        o.a1[i] = (const uint32_t *)ops[2 * i + 1];
        if (o.a0[i] == nullptr) return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < nplanes; ++i) {
        o.src[i] = (const uint32_t *)planes[2 * i];
        o.dst[i] = (uint32_t *)planes[2 * i + 1];
        if (o.src[i] == nullptr || o.dst[i] == nullptr)
            return (int)cudaErrorInvalidValue;
    }
    const int W = n_pad / 32;
    const int blocks = nops * (n_pad / TILE)
                       + nplanes * ((n_pad + 255) / 256) * (W / 4);
    elle_tile_bits<TILE><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        o, nops, n_pad, (int *)counts);
    return (int)cudaGetLastError();
}

// ptrs holds, for each of njobs jobs, fourteen pointers: x, out, then for
// terms 0 and 1 a0, a1, b0, b1, b0t, b1t (the transposes of b0 and b1; x,
// a1, b1, b1t and an unused term's may be null); nterms[j] is job j's
// term count (1 or 2) and term_ops[2 j + u] the row of term u's left
// operand in counts (elle_tile_bits' output for the same launch); forms
// (may be null) gets int32[njobs, n_pad / TILE]. Every plane is n_pad x
// n_pad / 32 u32 words, contiguous, 16-byte aligned; n_pad a multiple of
// 128. Returns the launch's cudaError (0 on success).
extern "C" int elle_pmm_launch(const void *const *ptrs, const int *nterms,
                               const int *term_ops, int njobs, int n_pad,
                               const void *counts, void *forms,
                               void *changed, void *stream) {
    if (njobs < 1 || njobs > MAX_JOBS || n_pad < TILE || n_pad % TILE != 0
        || counts == nullptr)
        return (int)cudaErrorInvalidValue;
    Jobs jobs = {};
    jobs.njobs = njobs;
    int n = 0;
    for (int pass = 2; pass >= 1; --pass) {       // two-term jobs first
        for (int j = 0; j < njobs; ++j) {
            if (nterms[j] != pass) continue;
            const void *const *p = ptrs + 14 * j;
            Job &job = jobs.j[n++];
            job.x = (const uint32_t *)p[0];
            job.out = (uint32_t *)p[1];
            job.nterms = nterms[j];
            job.slot = j;
            if (job.out == nullptr) return (int)cudaErrorInvalidValue;
            for (int t = 0; t < MAX_TERMS; ++t) {
                const void *const *q = p + 2 + 6 * t;
                job.t[t].a0 = (const uint32_t *)q[0];
                job.t[t].a1 = (const uint32_t *)q[1];
                job.t[t].b0 = (const uint32_t *)q[2];
                job.t[t].b1 = (const uint32_t *)q[3];
                job.t[t].b0t = (const uint32_t *)q[4];
                job.t[t].b1t = (const uint32_t *)q[5];
                job.op[t] = term_ops[2 * j + t];
                if (t < job.nterms
                    && (job.t[t].a0 == nullptr || job.t[t].b0 == nullptr
                        || job.t[t].b0t == nullptr
                        || (job.t[t].b1 == nullptr)
                               != (job.t[t].b1t == nullptr)
                        || job.op[t] < 0 || job.op[t] >= MAX_OPS))
                    return (int)cudaErrorInvalidValue;
            }
        }
    }
    if (n != njobs) return (int)cudaErrorInvalidValue;   // nterms not 1 / 2
    auto kernel = elle_pmm_kernel<BM, BN, STAGES>;
    const int smem = elle_pmm_smem(n_pad);
    cudaError_t err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    kernel<<<sms, NT, smem, (cudaStream_t)stream>>>(
        jobs, n_pad, (const int *)counts, (int *)forms, (int *)changed);
    return (int)cudaGetLastError();
}

// The product kernel's dynamic shared memory at n_pad, in bytes.
extern "C" int elle_pmm_smem(int n_pad) {
    return SMEM_BYTES + MAX_JOBS * (n_pad / TILE);
}
