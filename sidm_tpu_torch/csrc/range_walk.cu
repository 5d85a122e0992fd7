// The SIDM range walk of every target group, all levels in one launch.
// Port of sidm_tpu/ops/list_range.py:_record_segments (:94-202) with the
// range test of sidm_tpu/ops/fused_range.py:_range_classify (:99), plain
// XLA in the JAX package (no Pallas original); see
// sidm_tpu_torch/ops/fused_range.py (range_segments) for the contract and
// range_walk_plain for the level-by-level plain version it equals bit for
// bit.
//
// Per group, from START_LEVEL to the tree's depth: every frontier cell
// whose box (geometric centre +- s_l/2) lies within the group's pad of the
// group box is in range; an in-range leaf (count <= leaf_cap) appends its
// segment key start*32+min(cnt,31) to the group's list (under the level cap
// and the list cap), an in-range inner cell opens (its children, for the
// first O = min(W_l, open_cap) opened cells, form the next frontier,
// truncated at W_{l+1}), and on the last level the first big_cap in-range
// overfull cells are cut into 16-particle chunk keys (big_chunks a cell),
// appended after the level's segment keys. With a periodic box (box > 0)
// the distance is taken from the group box's centre by the minimum image,
// d - box*rint(d/box) (rint rounds half to even, as torch.round does).
// The hmax mode (T1, the tree SPH engine's hydro walk, port of
// sidm_tpu/ops/fused_sph.py:_sph_classify with use_hmax, :116-144) takes a
// cell within max(pad, hmax + drift) of the group box, hmax the cell's
// largest smoothing length (the range row's column 3) and drift the tree's
// refresh drift: d^2 <= max(pad^2, (hmax + drift)^2), the same decision as
// the plain version's d^2 <= max(pad, hmax + drift)^2 (a rounded square is
// monotone). Every product and sum is rounded explicitly (and the file
// builds with -fmad=false), so the decisions equal the plain version's.
//
// Design (what bounds it on the H100: bytes, the range rows of the
// classified cells and the (ng, seg_cap) key lists written). The live
// frontiers are narrow (about one smoothing length of pad around a
// 64-target group: tens of cells a level) but a few groups of the core
// open thousands. So a block of kT = 256 threads walks up to kGB = 8
// groups at once, level by level: each level's frontiers of its groups
// form one union that the block classifies in chunks of 256 cells, so
// narrow groups share a chunk and a wide group gets all 256 threads. With
// few groups (the DSMC walk's gated windows, the rate box) a block takes
// fewer of them, down to one, so that there are still four blocks for
// each one the card holds at once. Within a chunk a
// block-wide scan (warp ballots, a warp scan of the child counts, per-warp
// totals) gives every output its place; each group's place is the scan
// less its value before the group's first cell of the chunk, plus the
// group's running sum, so the outputs stay in frontier order per group.
// The next frontier stays on chip: each group's first fs ids (fs <= kFS)
// in a shared buffer, double-buffered between levels, the rest in a global
// scratch row of the group (a wide group, or every id when fs = 0); the
// next chunk's node rows and the chunk after it's ids are loaded while
// the current chunk is classified. The last level's overfull cells are cut
// into chunks by one warp a group, a lane a cell. The counts and the
// telemetry are kept in registers and written once, at the end of the
// walk, with the IMAX tail of each key list, and a block adds its groups'
// totals (drops, the largest demand) to the walk's by one atomic each;
// nothing else is read back or written between levels.
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace {

constexpr int kT = 256;            // threads per block
constexpr int kWarps = kT / 32;
constexpr int kGB = kWarps;        // groups per block (a warp each in the
                                   // epilogues)
constexpr int kFS = 256;           // frontier ids per group and buffer in
                                   // shared memory (ops/fused_range.py
                                   // RANGE_SHARED_IDS)
constexpr int kBigMax = 64;        // big_cap limit (ops/far_kernel.py
                                   // BIG_MAX)
constexpr int kMaxLevels = 24;
constexpr int kImax = 2147483647;

// rows of the telemetry output: ops/far_kernel.py S_*, then the walk's
// cap drops (open, big_over, big_drop)
enum { kNeedF, kNeedN, kOvfL, kOvfF, kOvfN, kOpen, kBigOver, kBigDrop,
       kNTele };
// the walk's totals (ops/fused_range.py R_*): dropped entries, the largest
// demand, the cap drops
enum { kSumOvf, kSumNeed, kSumOpen, kSumBigOver, kSumBigDrop, kNSums };
// a level's running sums per group: segment keys, opened cells, overfull
// cells, children of the opened cells
enum { kSeg, kOpn, kBig, kKid, kNSum };
// the group box in shared memory: lo xyz, hi xyz, centre xyz, half-width
// xyz, pad^2
enum { kLo = 0, kHi = 3, kGc = 6, kHw = 9, kPad2 = 12, kNBox };

struct Args {
    const float4* tbl;         // (M, 2) float4: the range rows of all levels
    const float* extent;       // () the tree's cube side
    const float* glo;          // (ng, 3) group boxes
    const float* ghi;
    const float* pad;          // (ng,)
    const float* drift;        // () the tree's drift: the hmax mode; null:
                               // the plain range test
    int* keys;                 // (ng, seg_cap) out, IMAX past nn
    int* nn;                   // (ng,) out
    long long* tele;           // (kNTele, ng) out
    long long* sums;           // (kNSums,) out, zeroed by the launcher
    int* scratch;              // (2, ng, sw) frontier ids past fs
    int ng, gb, seg_cap, sw, fs;   // gb: groups a block (<= kGB)
    int l0, depth;
    int open_cap, big_cap, big_chunks, lvl_cap;   // lvl_cap < 0: none
    float box, leaf_cap;
    int off[kMaxLevels];       // each level's first row in tbl
    int nl[kMaxLevels];        // each level's real cells
    int w[kMaxLevels];         // each level's frontier width cap
};

// The range test's gap along one axis in a periodic box: the cell centre c
// against the group box (centre gc, half-width hw) by the minimum image,
// max(|d| - hw - half, 0), rounded as the plain version rounds.
__device__ __forceinline__ float min_image_gap(float c, float gc, float hw,
                                               float half, float box) {
    float d = __fsub_rn(c, gc);
    d = __fsub_rn(d, __fmul_rn(box, rintf(__fdiv_rn(d, box))));
    return fmaxf(__fsub_rn(__fsub_rn(fabsf(d), hw), half), 0.0f);
}

__device__ __forceinline__ float gap(float c, float lo, float hi,
                                     float half) {
    return fmaxf(__fsub_rn(fmaxf(__fsub_rn(lo, c), __fsub_rn(c, hi)), half),
                 0.0f);
}

struct Row {
    float4 r0, r1;     // centre xyz, hmax | count, node start, child start,
                       // child count
};

__device__ __forceinline__ Row load_row(const float4* tl, int nl, int id) {
    Row r{make_float4(0.0f, 0.0f, 0.0f, 0.0f),
          make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    if (id >= 0 && id < nl) {
        r.r0 = __ldg(tl + 2 * (int64_t)id);
        r.r1 = __ldg(tl + 2 * (int64_t)id + 1);
    }
    return r;
}

// The group slot of union index u: the groups' frontiers lie one after the
// other, group s at [off[s], off[s + 1]).
__device__ __forceinline__ int slot_of(const int* off, int u) {
    int s = 0;
#pragma unroll
    for (int k = 1; k < kGB; ++k) s += off[k] <= u;
    return s;
}

// The frontier id of union index u of group slot s at a level (-1 past the
// union of T ids): on the first level the id itself, else the group's
// shared buffer (fr: (kGB, kFS), its first fs ids) or its global scratch
// row.
__device__ __forceinline__ int frontier_id(const Args& a, const int* fr,
                                           const int* off, int T, bool first,
                                           int rb, int g0, int u, int s) {
    if (u >= T) return -1;
    const int i = u - off[s];
    if (first) return i;
    if (i < a.fs) return fr[s * kFS + i];
    return a.scratch[((int64_t)rb * a.ng + g0 + s) * a.sw + (i - a.fs)];
}

__global__ void __launch_bounds__(kT) range_walk_kernel(const Args a) {
    __shared__ int fr[2][kGB][kFS];        // the frontiers' first fs ids
    __shared__ int sc[kNSum][kT];          // a chunk's block-inclusive scans
    __shared__ int wt[kWarps][kNSum];      // ... its per-warp totals
    __shared__ int base[2][kGB][kNSum];    // per group: sums before a chunk
    __shared__ int off[kGB + 1];           // the union's group offsets
    __shared__ int wid[kGB];               // next frontier widths
    __shared__ int kept[kGB];              // children of the first O opened
    __shared__ int nn_s[kGB];              // list fill
    __shared__ int big_st[kGB][kBigMax], big_ct[kGB][kBigMax];
    __shared__ float bx[kGB][kNBox];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    __shared__ long long red[kGB][kNSums];
    const int g0 = blockIdx.x * a.gb;
    const int ngb = min(a.gb, a.ng - g0);
    const float ext = *a.extent;
    const bool periodic = a.box > 0.0f;
    const bool use_hmax = a.drift != nullptr;
    const float drift = use_hmax ? *a.drift : 0.0f;
    const unsigned le = (2u << lane) - 1u;      // lanes <= this one

    if (tid < kGB) {
        const int s = tid, g = g0 + s;
        const bool v = s < ngb;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float lo = v ? a.glo[g * 3 + k] : 0.0f;
            const float hi = v ? a.ghi[g * 3 + k] : 0.0f;
            bx[s][kLo + k] = lo;
            bx[s][kHi + k] = hi;
            bx[s][kGc + k] = __fmul_rn(0.5f, __fadd_rn(lo, hi));
            bx[s][kHw + k] = __fmul_rn(0.5f, __fsub_rn(hi, lo));
        }
        const float p = v ? a.pad[g] : 0.0f;
        bx[s][kPad2] = __fmul_rn(p, p);
        nn_s[s] = 0;
        kept[s] = -1;
#pragma unroll
        for (int k = 0; k < kNSum; ++k) base[0][s][k] = base[1][s][k] = 0;
    }
    if (tid == 0) {
        off[0] = 0;
        for (int s = 0; s < kGB; ++s)
            off[s + 1] = off[s] + (s < ngb ? a.w[a.l0] : 0);
    }
    // per group, in lane 0 of its warp: the telemetry of the whole walk
    long long need = 0, ovf_l = 0, ovf_n = 0, open_drop = 0, big_over = 0,
              big_drop = 0;
    int cb = 0;                            // base[cb]: the current sums

    for (int l = a.l0; l <= a.depth; ++l) {
        const bool first = l == a.l0, last = l == a.depth;
        const int W = a.w[l], Wn = last ? 0 : a.w[l + 1];
        const int O = min(W, a.open_cap);
        const int LC = a.lvl_cap < 0 ? W : min(a.lvl_cap, W);
        const int nl = a.nl[l];
        const float4* tl = a.tbl + 2 * (int64_t)a.off[l];
        const float half = 0.5f * __fdiv_rn(ext, (float)(1 << l));
        const int rb = (l + 1) & 1, wb = l & 1;   // frontier read, written
        const int* frb = &fr[rb][0][0];
        __syncthreads();
        const int T = off[kGB];

        int s = tid < T ? slot_of(off, tid) : 0;
        Row row = load_row(tl, nl, frontier_id(a, frb, off, T, first, rb, g0,
                                               tid, s));
        int s_next = tid + kT < T ? slot_of(off, tid + kT) : 0;
        int id_next = frontier_id(a, frb, off, T, first, rb, g0, tid + kT,
                                  s_next);
        for (int c0 = 0; c0 < T; c0 += kT, cb ^= 1) {
            const Row row_next = load_row(tl, nl, id_next);
            const int ua = c0 + 2 * kT + tid;
            const int s_after = ua < T ? slot_of(off, ua) : 0;
            const int id_after = frontier_id(a, frb, off, T, first, rb,
                                             g0, ua, s_after);

            const bool in = c0 + tid < T;
            bool seg = false, opn = false, big = false;
            const float4 r0 = row.r0, r1 = row.r1;
            if (in) {
                const float* b = bx[s];
                float e0, e1, e2;
                if (periodic) {
                    e0 = min_image_gap(r0.x, b[kGc], b[kHw], half, a.box);
                    e1 = min_image_gap(r0.y, b[kGc + 1], b[kHw + 1], half,
                                       a.box);
                    e2 = min_image_gap(r0.z, b[kGc + 2], b[kHw + 2], half,
                                       a.box);
                } else {
                    e0 = gap(r0.x, b[kLo], b[kHi], half);
                    e1 = gap(r0.y, b[kLo + 1], b[kHi + 1], half);
                    e2 = gap(r0.z, b[kLo + 2], b[kHi + 2], half);
                }
                const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(e0, e0),
                                                     __fmul_rn(e1, e1)),
                                           __fmul_rn(e2, e2));
                float thr = b[kPad2];
                if (use_hmax) {
                    const float e = __fadd_rn(r0.w, drift);
                    thr = fmaxf(thr, __fmul_rn(e, e));
                }
                const bool live = r1.x > 0.0f && d2 <= thr;
                const bool leaf = r1.x <= a.leaf_cap;
                seg = live && leaf;
                opn = live && !leaf && !last;
                big = live && !leaf && last;
            }
            const int cc = opn ? (int)r1.w : 0;
            int inc[kNSum];
            inc[kSeg] = __popc(__ballot_sync(0xffffffffu, seg) & le);
            inc[kOpn] = __popc(__ballot_sync(0xffffffffu, opn) & le);
            inc[kBig] = __popc(__ballot_sync(0xffffffffu, big) & le);
            inc[kKid] = cc;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, inc[kKid], o);
                if (lane >= o) inc[kKid] += y;
            }
            if (lane == 31) {
#pragma unroll
                for (int k = 0; k < kNSum; ++k) wt[warp][k] = inc[k];
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < kNSum; ++k) {
                int p = 0;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) p += w < warp ? wt[w][k] : 0;
                inc[k] += p;
                sc[k][tid] = inc[k];
            }
            __syncthreads();
            if (in && (seg || opn || big)) {
                // the group's count of each kind before this cell: its sum
                // before the chunk, plus the chunk's scan less the scan
                // before the group's first cell in the chunk
                const int j0 = max(off[s] - c0, 0);
                int pre[kNSum];
#pragma unroll
                for (int k = 0; k < kNSum; ++k)
                    pre[k] = base[cb][s][k] + inc[k]
                             - (j0 > 0 ? sc[k][j0 - 1] : 0);
                const int g = g0 + s;
                if (seg) {
                    const int r = pre[kSeg] - 1;
                    if (r < LC && nn_s[s] + r < a.seg_cap)
                        a.keys[(int64_t)g * a.seg_cap + nn_s[s] + r] =
                            (int)r1.y * 32 + min((int)r1.x, 31);
                } else if (opn) {
                    const int r = pre[kOpn] - 1;
                    const int p = pre[kKid] - cc;
                    if (r == O) kept[s] = p;     // the first cell past O
                    if (r < O) {
                        const int cs = (int)r1.z;
                        for (int k = 0; k < cc && p + k < Wn; ++k) {
                            const int q = p + k;
                            if (q < a.fs)
                                fr[wb][s][q] = cs + k;
                            else
                                a.scratch[((int64_t)wb * a.ng + g) * a.sw
                                          + (q - a.fs)] = cs + k;
                        }
                    }
                } else {
                    const int r = pre[kBig] - 1;
                    if (r < a.big_cap) {
                        big_st[s][r] = (int)r1.y;
                        big_ct[s][r] = (int)r1.x;
                    }
                }
            }
            if (tid < kGB) {
                const int j0 = max(off[tid] - c0, 0);
                const int j1 = min(off[tid + 1] - c0, kT) - 1;
#pragma unroll
                for (int k = 0; k < kNSum; ++k)
                    base[cb ^ 1][tid][k] =
                        base[cb][tid][k]
                        + (j1 >= j0 ? sc[k][j1] - (j0 > 0 ? sc[k][j0 - 1] : 0)
                                    : 0);
            }
            s = s_next;
            row = row_next;
            s_next = s_after;
            id_next = id_after;
        }
        __syncthreads();

        // the level's epilogue, a warp per group
        if (warp < ngb) {
            const int sg = warp, g = g0 + sg;
            int* bs = base[cb][sg];
            const int n_seg = bs[kSeg], n_open = bs[kOpn], n_big = bs[kBig];
            const int n_kids = kept[sg] >= 0 ? kept[sg] : bs[kKid];
            const int ovf_open = last ? 0 : max(n_open - O, 0)
                                                + max(n_kids - Wn, 0);
            const int nn0 = nn_s[sg];
            const int ts = min(n_seg, LC);
            const int nn1 = min(nn0 + ts, a.seg_cap);
            int nn2 = nn1;
            if (last) {
                // the first big_cap overfull cells -> 16-particle chunk
                // keys after the level's segment keys, a lane a cell
                const int nb = min(n_big, a.big_cap);
                const int room = a.seg_cap - nn1;
                int* kg = a.keys + (int64_t)g * a.seg_cap + nn1;
                int done = 0, drop = 0;
                for (int b0 = 0; b0 < nb; b0 += 32) {
                    const int bi = b0 + lane;
                    const int c = bi < nb ? big_ct[sg][bi] : 0;
                    const int st = bi < nb ? big_st[sg][bi] : 0;
                    const int nch = bi < nb ? min(a.big_chunks, (c + 15) / 16)
                                            : 0;
                    int x = nch;
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const int y = __shfl_up_sync(0xffffffffu, x, o);
                        if (lane >= o) x += y;
                    }
                    const int p = done + x - nch;
                    for (int k = 0; k < nch && p + k < room; ++k)
                        kg[p + k] = (st + 16 * k) * 32 + min(c - 16 * k, 16);
                    drop += bi < nb ? max(c - 16 * a.big_chunks, 0) : 0;
                    done += __shfl_sync(0xffffffffu, x, 31);
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    drop += __shfl_xor_sync(0xffffffffu, drop, o);
                const int over = max(n_big - a.big_cap, 0);
                nn2 = min(nn1 + done, a.seg_cap);
                need += done + (long long)over * a.big_chunks;
                ovf_l += over;
                ovf_n += nn1 + done - nn2;
                big_over = over;
                big_drop = drop;
            }
            need += n_seg;
            ovf_l += max(n_seg - LC, 0) + ovf_open;
            ovf_n += nn0 + ts - nn1;
            open_drop += ovf_open;
            __syncwarp();
            if (lane == 0) {
                nn_s[sg] = nn2;
                kept[sg] = -1;
                wid[sg] = last ? 0 : min(n_kids, Wn);
#pragma unroll
                for (int k = 0; k < kNSum; ++k) bs[k] = 0;
            }
        }
        __syncthreads();
        if (tid == 0) {
            for (int sg = 0; sg < kGB; ++sg)
                off[sg + 1] = off[sg] + (sg < ngb ? wid[sg] : 0);
        }
    }
    __syncthreads();

    // the counts, the telemetry and the key lists' IMAX tails, once; the
    // block's totals added to the walk's
    if (warp < ngb) {
        const int g = g0 + warp;
        const int nf = nn_s[warp];
        if (lane == 0) {
            a.nn[g] = nf;
            const long long t[kNTele] = {0, need, ovf_l, 0, ovf_n, open_drop,
                                         big_over, big_drop};
#pragma unroll
            for (int k = 0; k < kNTele; ++k)
                a.tele[(int64_t)k * a.ng + g] = t[k];
            red[warp][kSumOvf] = ovf_l + ovf_n;
            red[warp][kSumNeed] = need;
            red[warp][kSumOpen] = open_drop;
            red[warp][kSumBigOver] = big_over;
            red[warp][kSumBigDrop] = big_drop;
        }
        const int64_t row0 = (int64_t)g * a.seg_cap;
        int* row = a.keys + row0;
        const int head = min((int)((4 - ((row0 + nf) & 3)) & 3),
                             a.seg_cap - nf);
        if (lane < head) row[nf + lane] = kImax;
        const int i0 = nf + head;
        const int nv = (a.seg_cap - i0) / 4;
        int4* vrow = reinterpret_cast<int4*>(row + i0);
        for (int v = lane; v < nv; v += 32)
            vrow[v] = make_int4(kImax, kImax, kImax, kImax);
        for (int j = i0 + 4 * nv + lane; j < a.seg_cap; j += 32)
            row[j] = kImax;
    }
    __syncthreads();
    if (tid < kNSums && ngb > 0) {
        long long v = red[0][tid];
        for (int sg = 1; sg < ngb; ++sg)
            v = tid == kSumNeed ? max(v, red[sg][tid]) : v + red[sg][tid];
        if (tid == kSumNeed)
            atomicMax(a.sums + tid, v);
        else if (v)
            atomicAdd(reinterpret_cast<unsigned long long*>(a.sums + tid),
                      (unsigned long long)v);
    }
}

}  // namespace

// tbl (M, 8) float32 range rows of every level; level_off, level_nl,
// level_w (depth + 1) host arrays: each level's first row, real cells and
// frontier width cap; extent, glo, ghi, pad device pointers; outputs keys
// (ng, seg_cap), nn (ng,), tele (8, ng) int64, all written whole, and sums
// (5,) int64 [dropped entries, largest demand, cap drops open, big_over,
// big_drop], zeroed here first; scratch (2, ng, sw) int32 holds the
// frontier ids past fs (<= 256) of each group; drift the tree's drift
// (a device scalar) for the hmax mode, null for the plain range test. A
// block walks gb groups:
// 8, or fewer when that leaves the card less than four blocks for each it
// holds at once (so that the blocks of the widest groups do not start
// last).
extern "C" int range_walk_launch(const float* tbl, const int* level_off,
                                 const int* level_nl, const int* level_w,
                                 int l0, int depth, const float* extent,
                                 const float* glo, const float* ghi,
                                 const float* pad, int ng, float box,
                                 float leaf_cap, int open_cap, int big_cap,
                                 int big_chunks, int lvl_cap, int seg_cap,
                                 int* keys, int* nn, long long* tele,
                                 long long* sums, int* scratch, int sw,
                                 int fs, const float* drift,
                                 void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(sums, 0, kNSums * sizeof(long long), st);
    if (e != cudaSuccess || ng <= 0) return (int)e;
    if (depth >= kMaxLevels || big_cap > kBigMax || fs < 0 || fs > kFS
        || seg_cap < 0)
        return (int)cudaErrorInvalidValue;
    Args a{};
    a.tbl = reinterpret_cast<const float4*>(tbl);
    a.extent = extent;
    a.glo = glo;
    a.ghi = ghi;
    a.pad = pad;
    a.drift = drift;
    a.keys = keys;
    a.nn = nn;
    a.tele = tele;
    a.sums = sums;
    a.scratch = scratch;
    a.ng = ng;
    a.seg_cap = seg_cap;
    a.sw = sw;
    a.fs = fs;
    a.l0 = l0;
    a.depth = depth;
    a.open_cap = open_cap;
    a.big_cap = big_cap;
    a.big_chunks = big_chunks;
    a.lvl_cap = lvl_cap;
    a.box = box;
    a.leaf_cap = leaf_cap;
    for (int l = 0; l <= depth; ++l) {
        a.off[l] = level_off[l];
        a.nl[l] = level_nl[l];
        a.w[l] = level_w[l];
    }
    static int cache[resident::kMaxDevices] = {};
    int held = 0;              // blocks the card holds at once
    e = resident::blocks(range_walk_kernel, kT, cache, &held);
    if (e != cudaSuccess) return (int)e;
    a.gb = kGB;
    while (a.gb > 1 && (ng + a.gb - 1) / a.gb < 4 * held) a.gb >>= 1;
    range_walk_kernel<<<(ng + a.gb - 1) / a.gb, kT, 0, st>>>(a);
    return (int)cudaGetLastError();
}
