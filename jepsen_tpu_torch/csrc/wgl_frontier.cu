// The serial row-frontier WGL walk, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgl.py::_build_kernel (:212, an XLA program,
// not Pallas: kernel :408-503, closure_tier :328, canonicalize :271,
// dominate :285, compact :305) with the row-frontier ops it builds on
// (jepsen_tpu/ops/frontier.py make_bit_ops :31, make_dedupe_compact :67).
// It is the engine the reference falls to wherever its batched kernels
// refuse a history: overlap past every plane, state spaces past
// max_states, crashed calls no crash tier settles.
//
// State.  A configuration is one row of KW = Wd + 1 32-bit key words:
// the mask words over the open-call slots (word 0 first), then the
// model state XOR 0x80000000 (every model here has one state word).
// Comparing rows word by word, unsigned, is the reference's sort order
// (lexsort with the mask words first, then the state words XOR the
// sign bit), so the survivors of a truncated dedupe are the reference's.
// The frontier enters and leaves in the reference's layout (masks
// u32[F][Wd], states i32[F], valid u8[F]); the valid rows are always a
// prefix (every compaction keeps order), so the walk carries their
// count n, and rows at or past n are written zero at the end, as the
// reference's compactions leave them.
//
// The walk, per return event r (slot ts, call tc), as the reference:
//   fast  the returning op is pure (the host's table of the model's
//         DeviceSpec.pure, one flag a call) and legal on every valid
//         config lacking ts: nothing changes;
//   slow  the closure in the smallest tier Fb of (64, 512, F) holding n
//         (a tier runs only when n <= Fb, or at F).  A round expands
//         each config lacking ts by each open candidate it has not
//         linearized and that is legal in its state; the pool (parents
//         and children) is canonicalized (crash groups) and deduped:
//         its rows sorted, the first of each run of equal rows kept,
//         the first Fb of them written in order.  The loop stops when
//         no config lacks ts, after C rounds, when the distinct count
//         no longer grows (without crash groups) or the repacked set
//         equals the last round's (with them: dominance, below, breaks
//         the count test), or at an overflow (more than Fb distinct).
//         An overflowing tier below F is dropped and the next tier
//         reruns from the event-start frontier; at F the truncated set
//         stays and the overflow flag is raised;
//   then  the configs lacking ts are pruned, the rest compacted in
//         order into the frontier with ts's bit cleared (the fast path
//         only clears it); an empty frontier ends the walk.
// Dominance (crash groups, tiers up to 4096 rows): a config whose
// crashed bits strictly contain another config's, with the same state
// and the same other bits, is dropped, then the set is repacked in
// order.
//
// Layout.  One CTA of NT = 1024 threads walks one history; every phase
// is a loop over rows strided by the thread index, with a barrier
// between phases, so every decision (fast or slow, the tier, the
// rounds) is the CTA's.  Children are appended to the pool with one
// shared atomic a warp (ballot, popc).  The dedupe is a bitonic sort of
// the pool's row indices, in shared memory up to SMEM_IDX rows and in
// global scratch past that, comparing rows in place in the pool, then a
// block scan over the sorted run starts.  The pool, the three working
// sets and the index array live in global scratch the wrapper
// allocates (ops/frontier_kernel.py scratch_words).
//
// What bounds it on this card.  One CTA uses one of 132 SMs, and each
// round is a chain of barriers (log2(P) * (log2(P) + 1) / 2 of them for
// a sort of P rows), so a walk is bound by latency, far above the
// bound the wrapper prices from the work it needs (expansions, sorted
// row-levels and dominance pairs over every INT32 lane).  The design
// keeps every round in one CTA so the frontier never leaves the card
// between events, and it sorts only the valid rows of the pool, not the
// reference's fixed Fb * (C + 1): the price of a round follows the live
// frontier.  Making it fast (several histories a launch, a sort that
// is not a single chain of barriers) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;          // threads of the walking CTA
constexpr int NWARPS = NT / 32;
constexpr int SMEM_IDX = 8192;    // sort indices kept in shared memory
constexpr int DOM_CAP = 4096;     // dominance tiers (the reference's cap)
constexpr int TIER_A = 64, TIER_B = 512;
constexpr uint32_t PAD = 0xFFFFFFFFu;
constexpr uint32_t SIGN = 0x80000000u;
constexpr unsigned FULLMASK = 0xFFFFFFFFu;

struct Args {
    const int *ret_call, *ret_slot, *cand_call, *cand_slot;
    const int *fv, *av, *bv;
    const uint8_t *okv, *purev;
    int C, r0, n_events, stop_r;
    uint32_t *masks;
    int *states;
    uint8_t *valid;
    int F, Wd;
    const uint32_t *cw, *gws, *luts;
    const int *sizes;
    int G, step;
    uint32_t *set0, *set1, *set2, *pool, *gidx;
    int *out;
    unsigned long long *work;
};

struct Shared {
    uint32_t idx[SMEM_IDX];
    uint8_t keep[DOM_CAP];
    int warp_sum[NWARPS];
    int count;
};

// The model's transition: legal or not, and the new state.
__device__ __forceinline__ bool step_op(int kind, int cur, int f, int a,
                                        int b, bool ok, int &nw) {
    if (kind == 0) {                       // register / cas-register
        const bool is_read = f == 0, is_write = f == 1, is_cas = f == 2;
        const bool legal = is_read ? (!ok || cur == a)
                                   : (is_cas ? cur == a : true);
        const int upd = is_write ? a : (is_cas ? b : cur);
        nw = legal ? upd : cur;
        return legal;
    }
    const bool locked = cur != 0, want = f == 0;        // mutex
    const bool legal = want ? !locked : locked;
    nw = legal ? (want ? 1 : 0) : cur;
    return legal;
}

__device__ __forceinline__ bool has_slot(const uint32_t *row, int slot) {
    return (row[slot >> 5] >> (slot & 31)) & 1u;
}

template <int KWT>
__device__ __forceinline__ bool row_less(const uint32_t *x,
                                         const uint32_t *y, int kw) {
    const int n = KWT ? KWT : kw;
    for (int w = 0; w < n; ++w)
        if (x[w] != y[w]) return x[w] < y[w];
    return false;
}

template <int KWT>
__device__ __forceinline__ bool row_ne(const uint32_t *x, const uint32_t *y,
                                       int kw) {
    const int n = KWT ? KWT : kw;
    for (int w = 0; w < n; ++w)
        if (x[w] != y[w]) return true;
    return false;
}

template <int KWT>
__device__ __forceinline__ void row_copy(uint32_t *dst, const uint32_t *src,
                                         int kw) {
    const int n = KWT ? KWT : kw;
    for (int w = 0; w < n; ++w) dst[w] = src[w];
}

// Exclusive block scan of one int a thread; *total gets the sum.  Every
// thread of the CTA must call it.
__device__ int block_scan(int x, int *total, Shared &sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULLMASK, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) sh.warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int v = sh.warp_sum[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULLMASK, v, o);
            if (lane >= o) v += y;
        }
        sh.warp_sum[lane] = v;            // inclusive over warps
    }
    __syncthreads();
    const int before = warp ? sh.warp_sum[warp - 1] : 0;
    *total = sh.warp_sum[NWARPS - 1];
    __syncthreads();                      // warp_sum is reused
    return before + incl - x;
}

// Sort idx[0, P2) (P2 a power of two; PAD entries sort last) by the rows
// they name in `rows`: a bitonic network, one barrier a stage.
template <int KWT>
__device__ void sort_rows(uint32_t *idx, int P2, const uint32_t *rows,
                          int kw) {
    for (int k = 2; k <= P2; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < P2; i += NT) {
                const int l = i ^ j;
                if (l <= i) continue;
                const uint32_t a = idx[i], b = idx[l];
                const bool asc = (i & k) == 0;
                // lo should precede hi in this half's direction
                const uint32_t lo = asc ? a : b, hi = asc ? b : a;
                bool swap;
                if (lo == PAD) swap = hi != PAD;
                else if (hi == PAD) swap = false;
                else swap = row_less<KWT>(rows + (size_t)hi * kw,
                                          rows + (size_t)lo * kw, kw);
                if (swap) { idx[i] = b; idx[l] = a; }
            }
            __syncthreads();
        }
    }
}

template <int KWT>
struct Walk {
    const Args &g;
    Shared &sh;
    const int kw, Wd;
    unsigned long long w_exp = 0, w_sort = 0, w_dom = 0;

    __device__ Walk(const Args &g_, Shared &sh_)
        : g(g_), sh(sh_), kw(KWT ? KWT : g_.Wd + 1),
          Wd((KWT ? KWT : g_.Wd + 1) - 1) {}

    // The distinct rows of pool[0, P) in sorted order, the first Fb of
    // them into dst; returns the distinct count.
    __device__ int dedupe(int P, uint32_t *dst, int Fb) {
        uint32_t *idx = P <= SMEM_IDX ? sh.idx : g.gidx;
        int P2 = 1;
        while (P2 < P) P2 <<= 1;
        for (int i = threadIdx.x; i < P2; i += NT)
            idx[i] = i < P ? (uint32_t)i : PAD;
        __syncthreads();
        sort_rows<KWT>(idx, P2, g.pool, kw);
        int carry = 0;
        for (int base = 0; base < P; base += NT) {
            const int i = base + threadIdx.x;
            bool first = false;
            if (i < P)
                first = i == 0 ||
                        row_ne<KWT>(g.pool + (size_t)idx[i] * kw,
                                    g.pool + (size_t)idx[i - 1] * kw, kw);
            int total;
            const int pos = carry + block_scan(first, &total, sh);
            if (first && pos < Fb)
                row_copy<KWT>(dst + (size_t)pos * kw,
                              g.pool + (size_t)idx[i] * kw, kw);
            carry += total;
        }
        __syncthreads();
        return carry;
    }

    // Keep the rows of src[0, m) with keep[i] (a predicate of i), in
    // order, in dst; returns the count.  dst may not alias src.
    template <typename Keep, typename Put>
    __device__ int compact(int m, Keep keep, Put put) {
        int carry = 0;
        for (int base = 0; base < m; base += NT) {
            const int i = base + threadIdx.x;
            const bool k = i < m && keep(i);
            int total;
            const int pos = carry + block_scan(k, &total, sh);
            if (k) put(i, pos);
            carry += total;
        }
        __syncthreads();
        return carry;
    }

    __device__ void canonicalize(uint32_t *row) {
        int off = 0;
        for (int gi = 0; gi < g.G; ++gi) {
            const uint32_t *gw = g.gws + (size_t)gi * Wd;
            int cnt = 0;
            for (int w = 0; w < Wd; ++w) cnt += __popc(row[w] & gw[w]);
            const uint32_t *lut = g.luts + (size_t)(off + cnt) * Wd;
            for (int w = 0; w < Wd; ++w) row[w] = (row[w] & ~gw[w]) | lut[w];
            off += g.sizes[gi] + 1;
        }
    }

    // keep[j] = 0 where row j of set[0, m) is dominated.
    __device__ void dominate(const uint32_t *set, int m) {
        for (int j = threadIdx.x; j < m; j += NT) {
            const uint32_t *rj = set + (size_t)j * kw;
            bool dom = false;
            for (int i = 0; i < m && !dom; ++i) {
                const uint32_t *ri = set + (size_t)i * kw;
                if (ri[Wd] != rj[Wd]) continue;
                bool eq = true, subset = true, proper = false;
                for (int w = 0; w < Wd; ++w) {
                    const uint32_t c = g.cw[w];
                    eq &= (ri[w] & ~c) == (rj[w] & ~c);
                    subset &= (ri[w] & c & ~rj[w]) == 0;
                    proper |= (ri[w] & c) != (rj[w] & c);
                }
                dom = eq && subset && proper;
            }
            sh.keep[j] = !dom;
        }
        __syncthreads();
    }

    // The closure of tier Fb from the frontier's first nb rows.  Returns
    // the rows' count; *set_out is the working set holding them.
    __device__ int closure(int Fb, int nb, int r, int ts, bool crash,
                           uint32_t **set_out, bool *ovf_out) {
        uint32_t *cur = g.set0, *nxt = g.set1, *tmp = g.set2;
        for (int e = threadIdx.x; e < nb * kw; e += NT) {
            const int i = e / kw, w = e - i * kw;
            cur[e] = w < Wd ? g.masks[(size_t)i * Wd + w]
                            : (uint32_t)g.states[i] ^ SIGN;
        }
        __syncthreads();
        const int C = g.C;
        const int *cc = g.cand_call + (size_t)r * C;
        const int *cs = g.cand_slot + (size_t)r * C;
        int rounds = 0, prev = -1;
        bool progressed = true, ovf = false;
        const int lane = threadIdx.x & 31;
        while (true) {
            bool lack = false;
            for (int i = threadIdx.x; i < nb; i += NT)
                lack |= !has_slot(cur + (size_t)i * kw, ts);
            const bool any_lack = __syncthreads_or(lack);
            if (!(any_lack && rounds < C && progressed && !ovf)) break;
            // the pool: the parents, then every legal child
            for (int e = threadIdx.x; e < nb * kw; e += NT)
                g.pool[e] = cur[e];
            if (threadIdx.x == 0) sh.count = nb;
            __syncthreads();
            const int total = nb * C;
            for (int base = 0; base < total; base += NT) {
                const int p = base + threadIdx.x;
                bool mk = false;
                int i = 0, slot = 0, nw = 0;
                if (p < total) {
                    i = p / C;
                    const int k = p - i * C;
                    const uint32_t *row = cur + (size_t)i * kw;
                    const int j = cc[k];
                    if (j >= 0 && !has_slot(row, ts)) {
                        ++w_exp;
                        slot = cs[k];
                        if (!has_slot(row, slot))
                            mk = step_op(g.step, (int)(row[Wd] ^ SIGN),
                                         g.fv[j], g.av[j], g.bv[j],
                                         g.okv[j] != 0, nw);
                    }
                }
                const unsigned bal = __ballot_sync(FULLMASK, mk);
                int at = 0;
                if (lane == 0 && bal) at = atomicAdd(&sh.count, __popc(bal));
                at = __shfl_sync(FULLMASK, at, 0);
                if (mk) {
                    uint32_t *dst = g.pool +
                        (size_t)(at + __popc(bal & ((1u << lane) - 1u))) * kw;
                    const uint32_t *row = cur + (size_t)i * kw;
                    for (int w = 0; w < Wd; ++w) dst[w] = row[w];
                    dst[slot >> 5] |= 1u << (slot & 31);
                    dst[Wd] = (uint32_t)nw ^ SIGN;
                }
            }
            __syncthreads();
            const int P = sh.count;
            if (crash && g.G > 0) {
                for (int i = threadIdx.x; i < P; i += NT)
                    canonicalize(g.pool + (size_t)i * kw);
                __syncthreads();
            }
            if (threadIdx.x == 0) {
                int lg = 0;
                while ((1 << lg) < P) ++lg;
                w_sort += (unsigned long long)P * lg;
            }
            const int D = dedupe(P, crash ? tmp : nxt, Fb);
            int m = D < Fb ? D : Fb;
            if (crash) {
                if (Fb <= DOM_CAP) {
                    if (threadIdx.x == 0)
                        w_dom += (unsigned long long)m * m;
                    dominate(tmp, m);
                    const uint32_t *src = tmp;
                    uint32_t *dst = nxt;
                    const int kwv = kw;
                    m = compact(m, [&](int i) { return sh.keep[i] != 0; },
                                [&](int i, int pos) {
                                    row_copy<KWT>(dst + (size_t)pos * kwv,
                                                  src + (size_t)i * kwv,
                                                  kwv);
                                });
                } else {
                    for (int e = threadIdx.x; e < m * kw; e += NT)
                        nxt[e] = tmp[e];
                    __syncthreads();
                }
                // the content fixpoint: the repacked set against the last
                bool diff = false;
                if (m == nb)
                    for (int e = threadIdx.x; e < m * kw; e += NT)
                        diff |= nxt[e] != cur[e];
                const bool changed = __syncthreads_or(diff);
                progressed = m != nb || changed;
            } else {
                progressed = D > prev;
            }
            prev = D;
            ovf = ovf || D > Fb;
            ++rounds;
            uint32_t *t = cur; cur = nxt; nxt = t;
            nb = m;
        }
        *set_out = cur;
        *ovf_out = ovf;
        return nb;
    }

    __device__ void run() {
        const int F = g.F;
        int total;
        int n = 0;
        for (int base = 0; base < F; base += NT) {
            const int i = base + threadIdx.x;
            block_scan(i < F && g.valid[i] != 0, &total, sh);
            n += total;
        }
        int r = g.r0;
        bool dead = false, overflow = false;
        const bool crash = g.cw != nullptr;
        while (r < g.n_events && r < g.stop_r && !dead) {
            const int ts = g.ret_slot[r];
            const int tc = g.ret_call[r];
            const int jt = tc > 0 ? tc : 0;
            bool fast = false;
            if (g.purev[jt]) {
                bool bad = false;
                for (int i = threadIdx.x; i < n; i += NT) {
                    const uint32_t *mrow = g.masks + (size_t)i * Wd;
                    if (has_slot(mrow, ts)) continue;
                    ++w_exp;
                    int nw;
                    bad |= !step_op(g.step, g.states[i], g.fv[jt], g.av[jt],
                                    g.bv[jt], g.okv[jt] != 0, nw);
                }
                fast = !__syncthreads_or(bad);
            }
            const int wi = ts >> 5;
            const uint32_t bit = 1u << (ts & 31);
            if (fast) {
                for (int i = threadIdx.x; i < n; i += NT)
                    g.masks[(size_t)i * Wd + wi] &= ~bit;
            } else {
                const int count = n;
                const int tiers[3] = {TIER_A, TIER_B, F};
                uint32_t *set = nullptr;
                int nb = 0;
                bool ovf = false;
                for (int t = 0; t < 3; ++t) {
                    const int Fb = tiers[t];
                    const bool last = t == 2;
                    if (!last && Fb >= F) continue;
                    if (!(count <= Fb || last)) continue;
                    nb = closure(Fb, count < Fb ? count : Fb, r, ts, crash,
                                 &set, &ovf);
                    if (!ovf || last) break;
                }
                const uint32_t *src = set;
                const int kwv = kw, Wdv = Wd;
                uint32_t *masks = g.masks;
                int *states = g.states;
                n = compact(nb,
                            [&](int i) {
                                return has_slot(src + (size_t)i * kwv, ts);
                            },
                            [&](int i, int pos) {
                                const uint32_t *row = src + (size_t)i * kwv;
                                for (int w = 0; w < Wdv; ++w)
                                    masks[(size_t)pos * Wdv + w] =
                                        w == wi ? row[w] & ~bit : row[w];
                                states[pos] = (int)(row[Wdv] ^ SIGN);
                            });
                overflow = overflow || ovf;
            }
            __syncthreads();
            dead = n == 0;
            ++r;
        }
        for (int i = threadIdx.x; i < F; i += NT) {
            g.valid[i] = i < n;
            if (i >= n) {
                for (int w = 0; w < Wd; ++w) g.masks[(size_t)i * Wd + w] = 0;
                g.states[i] = 0;
            }
        }
        if (g.work) {
            atomicAdd(&g.work[0], w_exp);
            if (threadIdx.x == 0) {
                atomicAdd(&g.work[1], w_sort);
                atomicAdd(&g.work[2], w_dom);
            }
        }
        if (threadIdx.x == 0) {
            g.out[0] = !dead;
            g.out[1] = dead ? r - 1 : -1;
            g.out[2] = overflow;
            g.out[3] = n;
            g.out[4] = r;
        }
    }
};

}  // namespace

template <int KWT>
__global__ void __launch_bounds__(NT, 1) wgl_frontier_kernel(Args g) {
    __shared__ Shared sh;
    Walk<KWT> walk(g, sh);
    walk.run();
}

extern "C" int wgl_frontier_launch(
    const void *ret_call, const void *ret_slot, const void *cand_call,
    const void *cand_slot, const void *fv, const void *av, const void *bv,
    const void *okv, const void *purev, int C, int r0, int n_events,
    int stop_r, void *masks, void *states, void *valid, int F, int Wd,
    const void *cw,
    const void *gws, const void *luts, const void *sizes, int G, int step,
    void *scratch, long long scratch_words, void *out, void *work,
    void *stream) {
    if (C < 1 || F < 1 || Wd < 1 || r0 < 0 || (step != 0 && step != 1) ||
        (cw != nullptr && (gws == nullptr || luts == nullptr ||
                           sizes == nullptr || G < 0)))
        return (int)cudaErrorInvalidValue;
    const long long kw = Wd + 1;
    const long long pool = (long long)F * (C + 1);
    long long p2 = 1;
    while (p2 < pool) p2 <<= 1;
    if (scratch_words < 3 * F * kw + pool * kw + p2 || pool * kw >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    Args g;
    g.ret_call = (const int *)ret_call;
    g.ret_slot = (const int *)ret_slot;
    g.cand_call = (const int *)cand_call;
    g.cand_slot = (const int *)cand_slot;
    g.fv = (const int *)fv;
    g.av = (const int *)av;
    g.bv = (const int *)bv;
    g.okv = (const uint8_t *)okv;
    g.purev = (const uint8_t *)purev;
    g.C = C;
    g.r0 = r0;
    g.n_events = n_events;
    g.stop_r = stop_r;
    g.masks = (uint32_t *)masks;
    g.states = (int *)states;
    g.valid = (uint8_t *)valid;
    g.F = F;
    g.Wd = Wd;
    g.cw = (const uint32_t *)cw;
    g.gws = (const uint32_t *)gws;
    g.luts = (const uint32_t *)luts;
    g.sizes = (const int *)sizes;
    g.G = cw != nullptr ? G : 0;
    g.step = step;
    uint32_t *s = (uint32_t *)scratch;
    g.set0 = s;
    g.set1 = s + F * kw;
    g.set2 = s + 2 * F * kw;
    g.pool = s + 3 * F * kw;
    g.gidx = g.pool + pool * kw;
    g.out = (int *)out;
    g.work = (unsigned long long *)work;
    cudaStream_t st = (cudaStream_t)stream;
    if (kw == 2)
        wgl_frontier_kernel<2><<<1, NT, 0, st>>>(g);
    else if (kw == 3)
        wgl_frontier_kernel<3><<<1, NT, 0, st>>>(g);
    else
        wgl_frontier_kernel<0><<<1, NT, 0, st>>>(g);
    return (int)cudaGetLastError();
}
