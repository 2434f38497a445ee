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
// The dedupe.  A row is its own sort key, and only the bits in which
// the pool's rows differ can order it: the OR and the AND of every row
// (taken as the pool is built) give each word's span of varying bits,
// and the spans, word 0 most significant, packed end to end, are a
// shorter key of K32 words (22 bits, one word, for the R = 18 deep
// history) that orders the pool exactly as the rows do; a row is the
// AND's constant bits with its span bits put back.  The keys, word by
// word (word c of key i at c * P + i), are sorted by a stable LSD radix
// sort of 8-bit digits over those bits only, least significant digit
// first: each pass counts every warp's digits over the warp's
// contiguous slice of keys (__match_any_sync: one leader a digit
// value), scans the counts in (digit, warp) order and scatters each key
// to its digit's next slot, ranked among its warp's peers, so equal
// digits keep their order.  Run starts (a key unequal to the one
// before) are then compacted in order, each warp ranking its slice's
// starts by ballot after one exchange of warp counts, and the first Fb
// distinct rows, rebuilt from their keys, are written.  Every ordered
// compaction of the walk (prune, dominance, run starts) is that one
// per-warp scan: two barriers, not a block scan of three barriers a
// block of rows.
//
// The pool.  Each parent gets the most threads (a power of two up to 32
// and C) that the CTA (or the grid) gives its parents; they walk the
// event's candidates, staged in shared memory once an event, every
// warp whose parents all hold ts skipping at once.  A warp's children
// take their rows from the pool's count by one atomic a candidate (on
// the grid, where the count is one global word, by one atomic for all
// of a warp's children after a pass that counts them).
//
// Layout and the two forms.  One CTA of NT = 1024 threads walks the
// events; every phase is a loop over rows, with barriers between
// phases, so every decision (fast or slow, the tier, the rounds) is the
// walking CTA's.  All 227 KB of shared memory are one dynamic array:
// the digit counts (256 x 32 warps), the scalars, the staged
// candidates, the spans, the working sets of tiers 64 and 512 (while KW
// <= SETS_KW_MAX) and the pool buffer (BW words, buffer_words below).
// A round's pool is built in that buffer (rows from its top down, the
// keys from its bottom up) when it is sure to fit: at most CAP = BW /
// (2 KW) rows, the rows and two key buffers of K32 <= KW words.  Where F
// (C + 1) rows, the most a pool can hold, fit in CAP the launch is that
// one CTA, and every round is built there.  Past it the launch is
// cooperative, one CTA an SM, all resident (cudaLaunchCooperativeKernel;
// the occupancy at this shared memory and these registers must allow
// one an SM, or the launch is refused), and a round whose bound on its
// pool, n + the pairs of rows lacking ts with open candidates they have
// not linearized (counted only where n + lacking rows x open candidates
// passes CAP), passes CAP is a job for the whole grid: the walking CTA
// writes it in a control block in global memory and bumps the job's
// number, which the other CTAs poll between jobs (with a short sleep:
// had they waited in a grid barrier instead, every SM spinning on its
// word, the walking CTA's rounds would have slowed); every CTA expands
// a slice of the parents into the pool in global scratch, with its
// rows' OR and AND, and meets the others at cooperative_groups' grid
// sync.  If two key buffers of the pool then fit the shared buffer,
// the walking CTA sorts it alone; else the grid compresses the keys
// and runs the same LSD passes device-wide (each CTA counts its slice's
// digits, a grid sync, each CTA scans every CTA's counts for its
// digits' bases, a stable scatter, a sync) and the same ordered
// compaction with a grid-wide exchange of counts.  A launch of one CTA
// first, going on as the grid only from the first event that needs
// it, was no faster on walks that never need it and slower on those
// that do (the wrapper must read the outputs between the launches).
//
// What bounds it on this card.  The events are a chain: each round
// needs the last one's frontier, so the walk is bound by the latency of
// its rounds, not by the operations its work= count prices (expansions,
// sorted row-levels and dominance pairs over every INT32 lane).  A
// round in shared memory costs about 4 barriers a radix pass (3 passes
// for 22 varying bits), a serial scan of the 32 warps' counts a pass,
// and a few barriers for the build and the compactions, where the first
// kernel paid one barrier a stage of a bitonic sort of indices
// (log2(P)(log2(P)+1)/2 stages, rows loaded from global memory); a grid
// round costs a job's post and 2 grid syncs and, past the shared
// buffer, 8 more syncs, and spreads its pool's rows over every SM.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;          // threads of a CTA
constexpr int NWARPS = NT / 32;
constexpr int DOM_CAP = 4096;     // dominance tiers (the reference's cap)
constexpr int TIER_A = 64, TIER_B = 512;
constexpr int RADIX = 256;        // 8-bit digits
constexpr uint32_t SIGN = 0x80000000u;
constexpr unsigned FULLMASK = 0xFFFFFFFFu;
// Shared memory: all of a block's on sm_90 (227 KB), one dynamic array.
constexpr int SMEM_BYTES = 232448;
constexpr int SMEM_WORDS = SMEM_BYTES / 4;
constexpr int HIST_WORDS = NWARPS * RADIX;   // per-warp digit counts
constexpr int SCAL_WORDS = 128;
constexpr int SETS_KW_MAX = 8;    // tier 64 / 512 sets in shared memory
constexpr int MAX_CTAS = 256;     // the grid form's CTAs (one an SM)
constexpr int CAND_CAP = 64;      // candidates staged in shared memory

// The scalars (shared words).
enum { S_WARP = 0,                // [32] per-warp counts of a compaction
       S_SUM = 32,                // [32] block_sum's warp sums
       S_DIG = 64,                // [8] digit scan's warp totals
       S_POOL = 72, S_NBITS, S_K32, S_NPC,
       S_FORMS = 80 };            // [3] rounds by form
// The control block (global words): the job's number and fields, then
// the pool's OR and AND.
enum { C_JOB = 0, C_POOL, C_KIND, C_NB, C_FB, C_R, C_TS, C_CRASH, C_CUR,
       C_DST, C_OR = 64 };
enum { JOB_ROUND = 1, JOB_QUIT = 2 };

// Words of the pool buffer in shared memory at KW words a row.
__host__ __device__ constexpr int buffer_words(int kw) {
    return SMEM_WORDS - HIST_WORDS - RADIX - SCAL_WORDS - 6 * CAND_CAP
           - 8 * kw - (kw <= SETS_KW_MAX ? 3 * TIER_B * kw : 0);
}

// Pool rows a round builds and sorts in shared memory, at any key width.
__host__ __device__ constexpr int capacity_rows(int kw) {
    return buffer_words(kw) / (2 * kw);
}

__host__ __device__ constexpr long long ctl_words(int kw) {
    return C_OR + 2LL * kw;
}

// Global scratch: control block, per-CTA digit counts, three working
// sets of F rows, and in the grid form the pool's rows and keys.
__host__ __device__ constexpr long long scratch_need(int F, int C, int kw,
                                                     bool grid) {
    return ctl_words(kw) + (long long)MAX_CTAS * RADIX
           + 3LL * F * kw + (grid ? 2LL * F * (C + 1) * kw : 0);
}

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
    uint32_t *set0, *set1, *set2, *rows, *keys;
    unsigned *ctl, *ghist;
    int grid;                     // launched as the cooperative grid
    int *out;
    unsigned long long *work, *forms;
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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULLMASK, v, o);
    return v;
}

__device__ __forceinline__ uint32_t warp_or(uint32_t v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(FULLMASK, v, o);
    return v;
}

__device__ __forceinline__ uint32_t warp_and(uint32_t v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v &= __shfl_xor_sync(FULLMASK, v, o);
    return v;
}

__device__ __forceinline__ uint32_t low_bits(int len) {
    return len >= 32 ? FULLMASK : (1u << len) - 1u;
}

__device__ __forceinline__ int ceil_log2(long long p) {
    int lg = 0;
    while ((1LL << lg) < p) ++lg;
    return lg;
}

// All CTAs of the cooperative grid meet; global writes before it are
// seen by every CTA after it.
__device__ __forceinline__ void grid_sync() {
    cooperative_groups::this_grid().sync();
}

template <int KWT>
struct Walk {
    const Args &g;
    const int kw, Wd;
    uint32_t *hist;               // [NWARPS][RADIX]; dominance's keep
    uint32_t *dbase;              // [RADIX] a pass's digit bases
    int *scal;
    uint32_t *orw, *andw;         // [kw] each
    uint32_t *omask;              // [kw] the open candidates' slots
    uint32_t *pieces;             // [2 kw][2] key spans
    int *cands;                   // [CAND_CAP][6] the event's candidates
    uint32_t *ssets;              // [3][TIER_B][kw] or null
    uint32_t *buf;                // [BW] the pool buffer
    int BW;
    unsigned long long w_exp = 0, w_sort = 0, w_dom = 0;

    __device__ Walk(const Args &g_, uint32_t *smem)
        : g(g_), kw(KWT ? KWT : g_.Wd + 1),
          Wd((KWT ? KWT : g_.Wd + 1) - 1) {
        hist = smem;
        dbase = hist + HIST_WORDS;
        scal = (int *)(dbase + RADIX);
        orw = (uint32_t *)scal + SCAL_WORDS;
        andw = orw + kw;
        omask = andw + kw;
        pieces = omask + kw;
        cands = (int *)(pieces + 5 * kw);
        uint32_t *p = (uint32_t *)cands + 6 * CAND_CAP;
        ssets = kw <= SETS_KW_MAX ? p : nullptr;
        buf = p + (kw <= SETS_KW_MAX ? 3 * TIER_B * kw : 0);
        BW = buffer_words(kw);
        if (threadIdx.x < 3) scal[S_FORMS + threadIdx.x] = 0;
    }

    // The block's sum of one int a thread.
    __device__ int block_sum(int v) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        v = warp_sum(v);
        if (lane == 0) scal[S_SUM + warp] = v;
        __syncthreads();
        const int t = warp_sum(scal[S_SUM + lane]);
        __syncthreads();
        return t;
    }

    // Ordered compaction of [lo, hi): put(i, pos) for each i with
    // keep(i), pos its rank among them (plus, on the grid, the earlier
    // CTAs' counts).  Each warp takes a contiguous slice, counts it,
    // and ranks its keeps by ballot after one exchange.  Returns the
    // count over the CTA (or the grid).  keep is called twice a row;
    // put must not change what keep reads.
    template <bool GRID, typename Keep, typename Put>
    __device__ int compact(int lo, int hi, Keep keep, Put put) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int n = hi > lo ? hi - lo : 0;
        const int per = (n + NT - 1) / NT * 32;
        const int wlo = lo + warp * per;
        const int whi = wlo + per < hi ? wlo + per : hi;
        int cnt = 0;
        for (int b = wlo; b < whi; b += 32) {
            const int i = b + lane;
            cnt += __popc(__ballot_sync(FULLMASK, i < whi && keep(i)));
        }
        if (lane == 0) scal[S_WARP + warp] = cnt;
        __syncthreads();
        const int wt = scal[S_WARP + lane];
        int pos = warp_sum(lane < warp ? wt : 0);
        int total = warp_sum(wt);
        if (GRID) {
            if (threadIdx.x == 0) g.ghist[blockIdx.x * RADIX] = total;
            grid_sync();
            int before = 0, all = 0;
            for (int b = lane; b < (int)gridDim.x; b += 32) {
                const int t = (int)g.ghist[b * RADIX];
                all += t;
                if (b < (int)blockIdx.x) before += t;
            }
            pos += warp_sum(before);
            total = warp_sum(all);
        }
        for (int b = wlo; b < whi; b += 32) {
            const int i = b + lane;
            const bool k = i < whi && keep(i);
            const unsigned bal = __ballot_sync(FULLMASK, k);
            if (k) put(i, pos + __popc(bal & ((1u << lane) - 1u)));
            pos += __popc(bal);
        }
        if (GRID) grid_sync();
        else __syncthreads();
        return total;
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

    // Event r's candidates k < CAND_CAP (call, slot and the call's
    // encoding) into cands, and every open candidate's slot into omask
    // (zeroed beforehand); a barrier must follow before expand reads
    // them.  Candidates past CAND_CAP are read from global memory.
    __device__ void stage_cands(int r) {
        const int C = g.C;
        for (int k = threadIdx.x; k < C; k += NT) {
            const int j = g.cand_call[(size_t)r * C + k];
            if (j >= 0) {
                const int slot = g.cand_slot[(size_t)r * C + k];
                atomicOr(omask + (slot >> 5), 1u << (slot & 31));
            }
        }
        for (int k = threadIdx.x; k < C && k < CAND_CAP; k += NT) {
            const int j = g.cand_call[(size_t)r * C + k];
            int *e = cands + 6 * k;
            e[0] = j;
            if (j >= 0) {
                e[1] = g.cand_slot[(size_t)r * C + k];
                e[2] = g.fv[j];
                e[3] = g.av[j];
                e[4] = g.bv[j];
                e[5] = g.okv[j];
            }
        }
    }

    // The pool of a round: the nb parents of cur, then every legal
    // child, canonicalized with crash groups; row p at rows + p * stride.
    // Each parent has tpr threads (a power of two, the most that nth
    // threads give nb parents, at most 32 and C), thread tid of nth
    // taking parents tid / tpr, (tid + nth) / tpr, ... and every tpr-th
    // candidate (staged by stage_cands) from tid % tpr; a warp none of
    // whose parents lacks ts goes on at once.  A warp's children get
    // their rows from the pool's count (*count, starting at nb) by one
    // atomic a candidate, or with `reserve` (on the grid, where the count
    // is one global word) by one atomic for all of the warp's children
    // after a pass that counts them.  Rows at or past cap are counted,
    // not written.  The OR and the AND of the rows written go into orw
    // and andw (set to 0 and ~0 beforehand).
    __device__ void expand(const uint32_t *cur, int nb, int r, int ts,
                           bool crash, uint32_t *rows, long long stride,
                           int cap, int *count, int tid, int nth,
                           bool reserve) {
        const int lane = threadIdx.x & 31;
        const bool canon = crash && g.G > 0;
        const int C = g.C;
        uint32_t o[KWT ? KWT : 1], an[KWT ? KWT : 1];
        for (int w = 0; w < (KWT ? KWT : 1); ++w) {
            o[w] = 0;
            an[w] = FULLMASK;
        }
        // a written row's words into the OR and the AND: in registers,
        // or at any row width by shared atomics
        auto note = [&](const uint32_t *v) {
            if constexpr (KWT > 0) {
#pragma unroll
                for (int w = 0; w < KWT; ++w) {
                    o[w] |= v[w];
                    an[w] &= v[w];
                }
            } else {
                for (int w = 0; w < kw; ++w) {
                    atomicOr(orw + w, v[w]);
                    atomicAnd(andw + w, v[w]);
                }
            }
        };
        int tpr = 1;
        while (tpr < 32 && tpr < C && 2LL * tpr * nb <= nth) tpr *= 2;
        const int sub = tid % tpr;
        int at = 0;
        for (int pass = reserve ? 0 : 1; pass < 2; ++pass) {
            int run = 0;
            for (int base = 0; base < nb; base += nth / tpr) {
                const int i = base + tid / tpr;
                const uint32_t *row = cur + (size_t)i * kw;
                if (pass == 1 && i < nb && sub == 0) {
                    uint32_t *dst = rows + i * stride;
                    for (int w = 0; w < kw; ++w) dst[w] = row[w];
                    if (canon) canonicalize(dst);
                    note(dst);
                }
                const bool lack = i < nb && !has_slot(row, ts);
                if (!__any_sync(FULLMASK, lack)) continue;
                uint32_t rw[KWT ? KWT : 1];
                if constexpr (KWT > 0) {
#pragma unroll
                    for (int w = 0; w < KWT; ++w) rw[w] = lack ? row[w] : 0;
                }
                auto word = [&](int w) -> uint32_t {
                    if constexpr (KWT > 0) {
                        uint32_t x = 0;
#pragma unroll
                        for (int u = 0; u < KWT; ++u)
                            if (u == w) x = rw[u];
                        return x;
                    } else {
                        return row[w];
                    }
                };
                const int st = lack ? (int)(word(Wd) ^ SIGN) : 0;
                for (int k0 = 0; k0 < C; k0 += tpr) {
                    const int k = k0 + sub;
                    int j = -1, slot = 0, f = 0, a = 0, b = 0, okv = 0;
                    if (k >= C) {
                    } else if (k < CAND_CAP) {
                        const int *e = cands + 6 * k;
                        j = e[0];
                        slot = e[1];
                        f = e[2];
                        a = e[3];
                        b = e[4];
                        okv = e[5];
                    } else {
                        j = g.cand_call[(size_t)r * C + k];
                        slot = j >= 0 ? g.cand_slot[(size_t)r * C + k] : 0;
                        f = j >= 0 ? g.fv[j] : 0;
                        a = j >= 0 ? g.av[j] : 0;
                        b = j >= 0 ? g.bv[j] : 0;
                        okv = j >= 0 ? g.okv[j] : 0;
                    }
                    int nw = 0;
                    bool mk = false;
                    if (lack && j >= 0) {
                        if (pass == 1) ++w_exp;
                        if (!((word(slot >> 5) >> (slot & 31)) & 1u))
                            mk = step_op(g.step, st, f, a, b, okv != 0, nw);
                    }
                    const unsigned bal = __ballot_sync(FULLMASK, mk);
                    if (!bal) continue;
                    if (pass == 0) {
                        run += __popc(bal);
                        continue;
                    }
                    if (!reserve) {
                        if (lane == 0) at = atomicAdd(count, __popc(bal));
                        at = __shfl_sync(FULLMASK, at, 0);
                    }
                    const int q =
                        at + run + __popc(bal & ((1u << lane) - 1u));
                    if (reserve) run += __popc(bal);
                    if (mk && q < cap) {
                        uint32_t *dst = rows + q * stride;
                        for (int w = 0; w < Wd; ++w)
                            dst[w] = word(w) |
                                     (w == slot >> 5 ? 1u << (slot & 31)
                                                     : 0u);
                        dst[Wd] = (uint32_t)nw ^ SIGN;
                        if (canon) canonicalize(dst);
                        note(dst);
                    }
                }
            }
            if (pass == 0) {
                if (lane == 0 && run) at = atomicAdd(count, run);
                at = __shfl_sync(FULLMASK, at, 0);
            }
        }
        if constexpr (KWT > 0) {
#pragma unroll
            for (int w = 0; w < KWT; ++w) {
                const uint32_t x = warp_or(o[w]), y = warp_and(an[w]);
                if (lane == 0 && x) atomicOr(orw + w, x);
                if (lane == 0 && y != FULLMASK) atomicAnd(andw + w, y);
            }
        }
    }

    // The key spans from orw / andw (thread 0), then a barrier: piece q
    // takes `len` bits at `lo` of row word w to bit cb of key word c
    // (key word 0 least significant).
    __device__ void make_pieces() {
        if (threadIdx.x == 0) {
            int nbits = 0, np = 0;
            for (int w = kw - 1; w >= 0; --w) {
                const uint32_t d = orw[w] ^ andw[w];
                if (!d) continue;
                int lo = __ffs(d) - 1;
                int len = 32 - __clz(d) - lo;
                while (len > 0) {
                    const int c = nbits >> 5, cb = nbits & 31;
                    const int take = len < 32 - cb ? len : 32 - cb;
                    pieces[2 * np] = (uint32_t)w | ((uint32_t)c << 16);
                    pieces[2 * np + 1] = (uint32_t)lo | ((uint32_t)take << 8)
                                         | ((uint32_t)cb << 16);
                    ++np;
                    nbits += take;
                    lo += take;
                    len -= take;
                }
            }
            scal[S_NBITS] = nbits;
            scal[S_K32] = (nbits + 31) >> 5;
            scal[S_NPC] = np;
        }
        __syncthreads();
    }

    // Key words of row i (rows + i * stride) into keys[c * P + i].
    __device__ void compress(const uint32_t *rows, long long stride, int i,
                             uint32_t *keys, int P, int K32, int np) {
        const uint32_t *row = rows + i * stride;
        int q = 0;
        for (int c = 0; c < K32; ++c) {
            uint32_t v = 0;
            for (; q < np && (int)(pieces[2 * q] >> 16) == c; ++q) {
                const uint32_t a = pieces[2 * q + 1];
                const int lo = a & 0xFF, len = (a >> 8) & 0xFF,
                          cb = a >> 16;
                v |= ((row[pieces[2 * q] & 0xFFFF] >> lo) & low_bits(len))
                     << cb;
            }
            keys[(size_t)c * P + i] = v;
        }
    }

    // Row words of key i (keys[c * P + i]) into dst[0, kw).
    __device__ void decompress(const uint32_t *keys, int P, int i,
                               uint32_t *dst, int np) {
        for (int w = 0; w < kw; ++w) dst[w] = andw[w];
        for (int q = 0; q < np; ++q) {
            const uint32_t a = pieces[2 * q + 1];
            const int w = pieces[2 * q] & 0xFFFF, c = pieces[2 * q] >> 16;
            const int lo = a & 0xFF, len = (a >> 8) & 0xFF, cb = a >> 16;
            dst[w] |= ((keys[(size_t)c * P + i] >> cb) & low_bits(len)) << lo;
        }
    }

    __device__ bool key_ne(const uint32_t *keys, int P, int K32, int i) {
        for (int c = 0; c < K32; ++c)
            if (keys[(size_t)c * P + i] != keys[(size_t)c * P + i - 1])
                return true;
        return false;
    }

    // One stable pass of the 8-bit digit at bit sh of key word c, src to
    // dst (each K32 words a key, word c of key i at c * P + i), over this
    // CTA's keys [lo, hi); on the grid, bases over every CTA's counts.
    template <bool GRID>
    __device__ void radix_pass(const uint32_t *src, uint32_t *dst, int P,
                               int K32, int c, int sh, int lo, int hi) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int n = hi > lo ? hi - lo : 0;
        const int per = (n + NT - 1) / NT * 32;
        const int wlo = lo + warp * per;
        const int whi = wlo + per < hi ? wlo + per : hi;
        const int used = per ? (n + per - 1) / per : 0;  // warps with rows
        uint32_t *h = hist + warp * RADIX;      // zero (zero_hist)
        const uint32_t *sc = src + (size_t)c * P;
        for (int b = wlo; b < whi; b += 32) {
            const int i = b + lane;
            const uint32_t d = i < whi ? (sc[i] >> sh) & 0xFFu : RADIX;
            const unsigned peers = __match_any_sync(FULLMASK, d);
            if (i < whi && lane == __ffs(peers) - 1) h[d] += __popc(peers);
        }
        __syncthreads();
        const int t = threadIdx.x;
        uint32_t tot = 0, before = 0;
        if (t < RADIX) {
            for (int w = 0; w < used; ++w) {
                const uint32_t x = hist[w * RADIX + t];
                hist[w * RADIX + t] = tot;
                tot += x;
            }
        }
        if (GRID) {
            if (t < RADIX) g.ghist[blockIdx.x * RADIX + t] = tot;
            grid_sync();
            if (t < RADIX) {
                uint32_t all = 0;
                for (int b = 0; b < (int)gridDim.x; ++b) {
                    const uint32_t x = g.ghist[b * RADIX + t];
                    all += x;
                    if (b < (int)blockIdx.x) before += x;
                }
                tot = all;
            }
        }
        // exclusive scan of tot over the digits (warps 0..7)
        uint32_t incl = tot;
        if (t < RADIX) {
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const uint32_t y = __shfl_up_sync(FULLMASK, incl, o);
                if (lane >= o) incl += y;
            }
            if (lane == 31) scal[S_DIG + warp] = (int)incl;
        }
        __syncthreads();
        if (t < RADIX) {
            uint32_t off = 0;
            for (int w = 0; w < warp; ++w) off += (uint32_t)scal[S_DIG + w];
            dbase[t] = off + incl - tot + before;
        }
        __syncthreads();
        for (int b = wlo; b < whi; b += 32) {
            const int i = b + lane;
            const bool in = i < whi;
            const uint32_t d = in ? (sc[i] >> sh) & 0xFFu : RADIX;
            const unsigned peers = __match_any_sync(FULLMASK, d);
            uint32_t pos = 0;
            if (in)
                pos = dbase[d] + h[d] +
                      __popc(peers & ((1u << lane) - 1u));
            __syncwarp();
            if (in && lane == __ffs(peers) - 1) h[d] += __popc(peers);
            __syncwarp();
            if (in)
                for (int k = 0; k < K32; ++k)
                    dst[(size_t)k * P + pos] = src[(size_t)k * P + i];
        }
        if (warp < used)
            for (int d = lane; d < RADIX; d += 32) h[d] = 0;
        if (GRID) grid_sync();
        else __syncthreads();
    }

    // Every warp's digit counts to 0, before a sort's first pass (a pass
    // leaves them 0; dominance's keep flags share them).
    __device__ void zero_hist() {
        for (int e = threadIdx.x; e < HIST_WORDS; e += NT) hist[e] = 0;
    }

    // Sort the keys of [lo, hi) of P from *a (the other buffer *b) over
    // every varying digit; *a holds the sorted keys after.
    template <bool GRID>
    __device__ void radix_sort(uint32_t **a, uint32_t **b, int P, int lo,
                               int hi) {
        const int nbits = scal[S_NBITS], K32 = scal[S_K32];
        for (int bit = 0; bit < nbits; bit += 8) {
            radix_pass<GRID>(*a, *b, P, K32, bit >> 5, bit & 31, lo, hi);
            uint32_t *t = *a; *a = *b; *b = t;
        }
    }

    // The first Fb distinct rows of the sorted keys (from this CTA's
    // [lo, hi)) into dst; returns the distinct count.
    template <bool GRID>
    __device__ int runs_out(const uint32_t *keys, int P, int lo, int hi,
                            uint32_t *dst, int Fb) {
        const int K32 = scal[S_K32], np = scal[S_NPC];
        const int kwv = kw;
        return compact<GRID>(
            lo, hi,
            [&](int i) { return i == 0 || key_ne(keys, P, K32, i); },
            [&](int i, int pos) {
                if (pos < Fb)
                    decompress(keys, P, i, dst + (size_t)pos * kwv, np);
            });
    }

    // Dedupe P pool rows (rows + p * stride; OR and AND in orw / andw)
    // in this CTA's shared buffer: the first Fb distinct into dst.
    __device__ int dedupe_local(const uint32_t *rows, long long stride,
                                int P, uint32_t *dst, int Fb) {
        make_pieces();
        const int K32 = scal[S_K32], np = scal[S_NPC];
        uint32_t *a = buf, *b = buf + (size_t)K32 * P;
        zero_hist();
        for (int i = threadIdx.x; i < P; i += NT)
            compress(rows, stride, i, a, P, K32, np);
        __syncthreads();
        radix_sort<false>(&a, &b, P, 0, P);
        return runs_out<false>(a, P, 0, P, dst, Fb);
    }

    // A grid job's round, every CTA (the walking CTA posted it): expand
    // into the global pool, OR and AND; then the walking CTA sorts it
    // alone if two key buffers fit its shared buffer (returns -1 on the
    // other CTAs), else the grid sorts and compacts it into dst.
    // Returns the distinct count on the walking CTA.
    __device__ int grid_round(uint32_t *dst_local) {
        unsigned *ctl = g.ctl;
        const volatile unsigned *vc = ctl;
        const int nb = (int)vc[C_NB], Fb = (int)vc[C_FB], r = (int)vc[C_R],
                  ts = (int)vc[C_TS];
        const bool crash = vc[C_CRASH] != 0;
        uint32_t *sets[3] = {g.set0, g.set1, g.set2};
        const uint32_t *cur = sets[vc[C_CUR]];
        uint32_t *dst = sets[vc[C_DST]];
        stage_cands(r);
        for (int w = threadIdx.x; w < kw; w += NT) {
            orw[w] = 0;
            andw[w] = FULLMASK;
        }
        __syncthreads();
        expand(cur, nb, r, ts, crash, g.rows, kw, 0x7FFFFFFF,
               (int *)(ctl + C_POOL), blockIdx.x * NT + threadIdx.x,
               NT * gridDim.x, true);
        __syncthreads();
        for (int w = threadIdx.x; w < kw; w += NT) {
            if (orw[w]) atomicOr(ctl + C_OR + w, orw[w]);
            if (andw[w] != FULLMASK) atomicAnd(ctl + C_OR + kw + w, andw[w]);
        }
        grid_sync();
        const int P = (int)vc[C_POOL];
        const int S = ((P + gridDim.x - 1) / gridDim.x + 31) / 32 * 32;
        const int lo = blockIdx.x * S < P ? blockIdx.x * S : P;
        const int hi = lo + S < P ? lo + S : P;
        for (int w = threadIdx.x; w < kw; w += NT) {
            orw[w] = vc[C_OR + w];
            andw[w] = vc[C_OR + kw + w];
        }
        __syncthreads();
        make_pieces();
        const int K32 = scal[S_K32], np = scal[S_NPC];
        if (2LL * K32 * P <= BW) {
            grid_sync();                   // every CTA has read the job
            if (blockIdx.x != 0) return -1;
            uint32_t *a = buf, *b = buf + (size_t)K32 * P;
            zero_hist();
            for (int i = threadIdx.x; i < P; i += NT)
                compress(g.rows, kw, i, a, P, K32, np);
            __syncthreads();
            radix_sort<false>(&a, &b, P, 0, P);
            if (threadIdx.x == 0) ++scal[S_FORMS + 1];
            return runs_out<false>(a, P, 0, P, dst_local, Fb);
        }
        uint32_t *a = g.keys, *b = g.rows;
        zero_hist();
        for (int i = lo + threadIdx.x; i < hi; i += NT)
            compress(g.rows, kw, i, a, P, K32, np);
        grid_sync();
        radix_sort<true>(&a, &b, P, lo, hi);
        if (blockIdx.x == 0 && threadIdx.x == 0) ++scal[S_FORMS + 2];
        const int D = runs_out<true>(a, P, lo, hi, dst, Fb);
        if (blockIdx.x != 0) return -1;
        if (dst != dst_local) {
            const int m = D < Fb ? D : Fb;
            for (int e = threadIdx.x; e < m * kw; e += NT)
                dst_local[e] = dst[e];
            __syncthreads();
        }
        return D;
    }

    // The walking CTA: post a round to the grid and take part in it.
    // cur / dst in shared memory are staged through set0 / set1.
    __device__ int post_round(const uint32_t *cur, int nb, uint32_t *dst,
                              int Fb, int r, int ts, bool crash) {
        uint32_t *sets[3] = {g.set0, g.set1, g.set2};
        int cs = 0, ds = 1;
        const bool local = ssets != nullptr && Fb <= TIER_B;
        if (local) {
            for (int e = threadIdx.x; e < nb * kw; e += NT)
                g.set0[e] = cur[e];
        } else {
            for (int s = 0; s < 3; ++s) {
                if (cur == sets[s]) cs = s;
                if (dst == sets[s]) ds = s;
            }
        }
        if (threadIdx.x == 0) {
            unsigned *c = g.ctl;
            c[C_KIND] = JOB_ROUND;
            c[C_NB] = nb;
            c[C_FB] = Fb;
            c[C_R] = r;
            c[C_TS] = ts;
            c[C_CRASH] = crash;
            c[C_CUR] = cs;
            c[C_DST] = ds;
            c[C_POOL] = nb;
            for (int w = 0; w < kw; ++w) {
                c[C_OR + w] = 0;
                c[C_OR + kw + w] = FULLMASK;
            }
        }
        post();
        return grid_round(dst);
    }

    // keep[j] = 0 where row j of set[0, m) is dominated.
    __device__ void dominate(const uint32_t *set, int m) {
        uint8_t *keep = (uint8_t *)hist;
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
            keep[j] = !dom;
        }
        __syncthreads();
    }

    // The closure of tier Fb from the frontier's first nb rows.  Returns
    // the rows' count; *set_out is the working set holding them.
    __device__ int closure(int Fb, int nb, int r, int ts, bool crash,
                           uint32_t **set_out, bool *ovf_out) {
        const bool local = ssets != nullptr && Fb <= TIER_B;
        uint32_t *cur = local ? ssets : g.set0;
        uint32_t *nxt = local ? ssets + TIER_B * kw : g.set1;
        uint32_t *tmp = local ? ssets + 2 * TIER_B * kw : g.set2;
        for (int e = threadIdx.x; e < nb * kw; e += NT) {
            const int i = e / kw, w = e - i * kw;
            cur[e] = w < Wd ? g.masks[(size_t)i * Wd + w]
                            : (uint32_t)g.states[i] ^ SIGN;
        }
        for (int w = threadIdx.x; w < kw; w += NT) omask[w] = 0;
        __syncthreads();
        stage_cands(r);
        int copen = 0;
        for (int k = threadIdx.x; k < g.C; k += NT)
            copen += g.cand_call[(size_t)r * g.C + k] >= 0;
        copen = block_sum(copen);
        const int cap = capacity_rows(kw);
        int rounds = 0, prev = -1;
        bool progressed = true, ovf = false;
        while (true) {
            int lack;
            if (nb <= NT) {
                lack = __syncthreads_count(
                    threadIdx.x < nb &&
                    !has_slot(cur + (size_t)threadIdx.x * kw, ts));
            } else {
                lack = 0;
                for (int i = threadIdx.x; i < nb; i += NT)
                    lack += !has_slot(cur + (size_t)i * kw, ts);
                lack = block_sum(lack);
            }
            if (!(lack > 0 && rounds < g.C && progressed && !ovf)) break;
            // on the grid, the round's bound: the parents and the pairs
            // of rows lacking ts with the open candidates they have not
            // linearized (counted only when lack * copen does not settle
            // it)
            bool local = true;
            if (g.grid && nb + (long long)lack * copen > cap) {
                int pairs = 0;
                for (int i = threadIdx.x; i < nb; i += NT) {
                    const uint32_t *row = cur + (size_t)i * kw;
                    if (has_slot(row, ts)) continue;
                    int lin = 0;
                    for (int w = 0; w < Wd; ++w)
                        lin += __popc(row[w] & omask[w]);
                    pairs += copen - lin;
                }
                local = nb + block_sum(pairs) <= cap;
            }
            uint32_t *out = crash ? tmp : nxt;
            int P, D;
            if (local) {
                // the pool in the shared buffer, rows from its top down
                uint32_t *rows = buf + BW - kw;
                const long long stride = -kw;
                if (threadIdx.x == 0) scal[S_POOL] = nb;
                for (int w = threadIdx.x; w < kw; w += NT) {
                    orw[w] = 0;
                    andw[w] = FULLMASK;
                }
                __syncthreads();
                expand(cur, nb, r, ts, crash, rows, stride, cap,
                       &scal[S_POOL], threadIdx.x, NT, false);
                __syncthreads();
                P = scal[S_POOL];
                D = dedupe_local(rows, stride, P, out, Fb);
                if (threadIdx.x == 0) ++scal[S_FORMS];
            } else {
                D = post_round(cur, nb, out, Fb, r, ts, crash);
                P = (int)((volatile unsigned *)g.ctl)[C_POOL];
            }
            if (threadIdx.x == 0) w_sort += (unsigned long long)P * ceil_log2(P);
            int m = D < Fb ? D : Fb;
            if (crash) {
                if (Fb <= DOM_CAP) {
                    if (threadIdx.x == 0)
                        w_dom += (unsigned long long)m * m;
                    dominate(tmp, m);
                    const uint8_t *keep = (const uint8_t *)hist;
                    const uint32_t *src = tmp;
                    uint32_t *dst = nxt;
                    const int kwv = kw;
                    m = compact<false>(
                        0, m, [&](int i) { return keep[i] != 0; },
                        [&](int i, int pos) {
                            for (int w = 0; w < kwv; ++w)
                                dst[(size_t)pos * kwv + w] =
                                    src[(size_t)i * kwv + w];
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
        int n = 0;
        for (int i = threadIdx.x; i < F; i += NT) n += g.valid[i] != 0;
        n = block_sum(n);
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
                n = compact<false>(
                    0, nb,
                    [&](int i) { return has_slot(src + (size_t)i * kwv, ts); },
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
        if (g.grid) {
            if (threadIdx.x == 0) g.ctl[C_KIND] = JOB_QUIT;
            post();
        }
        for (int i = threadIdx.x; i < F; i += NT) {
            g.valid[i] = i < n;
            if (i >= n) {
                for (int w = 0; w < Wd; ++w) g.masks[(size_t)i * Wd + w] = 0;
                g.states[i] = 0;
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

    // The walking CTA: publish the job its thread 0 wrote.
    __device__ void post() {
        __syncthreads();
        if (threadIdx.x == 0) {
            __threadfence();
            atomicAdd(g.ctl + C_JOB, 1u);
        }
    }

    // A CTA past the first: take part in every job until the quit,
    // waiting for each on the job's number (a grid barrier would spin
    // on one word from every SM while the walking CTA works alone).
    __device__ void serve() {
        const volatile unsigned *vc = g.ctl;
        for (unsigned seen = 1;; ++seen) {
            if (threadIdx.x == 0) {
                while (vc[C_JOB] < seen) __nanosleep(20);
                __threadfence();
            }
            __syncthreads();
            if (vc[C_KIND] == JOB_QUIT) return;
            grid_round(nullptr);
        }
    }

    __device__ void finish() {
        if (g.work) {
            atomicAdd(&g.work[0], w_exp);
            if (threadIdx.x == 0) {
                atomicAdd(&g.work[1], w_sort);
                atomicAdd(&g.work[2], w_dom);
            }
        }
        if (g.forms && threadIdx.x == 0)
            for (int k = 0; k < 3; ++k)
                atomicAdd(&g.forms[k],
                          (unsigned long long)scal[S_FORMS + k]);
    }
};

}  // namespace

template <int KWT>
__global__ void __launch_bounds__(NT, 1) wgl_frontier_kernel(Args g) {
    extern __shared__ uint32_t smem[];
    Walk<KWT> walk(g, smem);
    if (blockIdx.x == 0) walk.run();
    else walk.serve();
    walk.finish();
}

namespace {

// The grid form's CTAs on the current device: one an SM, if the
// occupancy at this shared memory and these registers allows one.
template <int KWT>
int grid_ctas(int *ctas) {
    auto kernel = wgl_frontier_kernel<KWT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    int dev = 0, nsm = 0, occ = 0;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, NT, SMEM_BYTES)) != cudaSuccess)
        return (int)err;
    if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    *ctas = nsm < MAX_CTAS ? nsm : MAX_CTAS;
    return 0;
}

template <int KWT>
int launch_kw(Args &g, cudaStream_t st, int *ctas) {
    auto kernel = wgl_frontier_kernel<KWT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (!g.grid) {
        *ctas = 1;
        wgl_frontier_kernel<KWT><<<1, NT, SMEM_BYTES, st>>>(g);
        return (int)cudaGetLastError();
    }
    const int rc = grid_ctas<KWT>(ctas);
    if (rc != 0) return rc;
    void *args[] = {&g};
    err = cudaLaunchCooperativeKernel((const void *)kernel, dim3(*ctas),
                                      dim3(NT), args, SMEM_BYTES, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// The layout a walk at (F, C, Wd) takes: out[0] pool rows a round sorts
// in shared memory at any key width, out[1] 1 for the grid form (a
// pool, at most F (C + 1) rows, can outgrow that), out[2] global scratch
// words, out[3] dynamic shared memory bytes, out[4] the pool buffer's
// words, out[5] the launch's CTAs on the current device.
extern "C" int wgl_frontier_layout(int F, int C, int Wd, long long *out) {
    if (F < 1 || C < 1 || Wd < 1) return (int)cudaErrorInvalidValue;
    const int kw = Wd + 1;
    if (buffer_words(kw) < 2 * kw) return (int)cudaErrorInvalidValue;
    const bool grid = (long long)F * (C + 1) > capacity_rows(kw);
    int ctas = 1;
    if (grid) {
        const int rc = kw == 2 ? grid_ctas<2>(&ctas)
                     : kw == 3 ? grid_ctas<3>(&ctas) : grid_ctas<0>(&ctas);
        if (rc != 0) return rc;
    }
    out[0] = capacity_rows(kw);
    out[1] = grid;
    out[2] = scratch_need(F, C, kw, grid);
    out[3] = SMEM_BYTES;
    out[4] = buffer_words(kw);
    out[5] = ctas;
    return 0;
}

extern "C" int wgl_frontier_launch(
    const void *ret_call, const void *ret_slot, const void *cand_call,
    const void *cand_slot, const void *fv, const void *av, const void *bv,
    const void *okv, const void *purev, int C, int r0, int n_events,
    int stop_r, void *masks, void *states, void *valid, int F, int Wd,
    const void *cw,
    const void *gws, const void *luts, const void *sizes, int G, int step,
    void *scratch, long long scratch_words, void *out, void *work,
    void *forms, void *ctas_out, void *stream) {
    long long lay[6];
    if (wgl_frontier_layout(F, C, Wd, lay) != 0 || r0 < 0 ||
        (step != 0 && step != 1) ||
        (cw != nullptr && (gws == nullptr || luts == nullptr ||
                           sizes == nullptr || G < 0)))
        return (int)cudaErrorInvalidValue;
    const long long kw = Wd + 1;
    const long long pool = (long long)F * (C + 1);
    if (scratch_words < lay[2] || pool * kw >= (1LL << 31))
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
    g.grid = (int)lay[1];
    uint32_t *s = (uint32_t *)scratch;
    g.ctl = (unsigned *)s;
    g.ghist = (unsigned *)(s + ctl_words(kw));
    g.set0 = s + ctl_words(kw) + (long long)MAX_CTAS * RADIX;
    g.set1 = g.set0 + F * kw;
    g.set2 = g.set1 + F * kw;
    g.rows = g.grid ? g.set2 + F * kw : nullptr;
    g.keys = g.grid ? g.rows + pool * kw : nullptr;
    g.out = (int *)out;
    g.work = (unsigned long long *)work;
    g.forms = (unsigned long long *)forms;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(g.ctl, 0, ctl_words(kw) * 4, st);
    if (err != cudaSuccess) return (int)err;
    int ctas = 0;
    int rc;
    if (kw == 2)
        rc = launch_kw<2>(g, st, &ctas);
    else if (kw == 3)
        rc = launch_kw<3>(g, st, &ctas);
    else
        rc = launch_kw<0>(g, st, &ctas);
    if (ctas_out) *(int *)ctas_out = ctas;
    return rc;
}
