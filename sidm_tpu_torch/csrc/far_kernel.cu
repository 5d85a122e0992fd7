// One walk level: classify every group's frontier and write the results in
// their compacted form. Port of sidm_tpu/ops/pallas_far.py:_far_kernel
// (classification and key emission; see sidm_tpu_torch/ops/far_kernel.py
// for the contract and the design note).
//
// The TPU kernel emits dense (group, frontier slot) key planes that XLA
// then compacts. Here one thread block owns one target group and walks its
// frontier in order, kT = 128 ids per chunk, so it writes each stream
// already compacted, in frontier order:
//   * accepted (far) nodes: level-local ids (walk), or flat ids appended
//     to the group's far list under the level cap and the list cap
//     (record);
//   * opened leaves: segment keys nstart*32+min(cnt,31), likewise into a
//     (ng, W) buffer or appended to the group's near list;
//   * opened inner cells: the first O = min(W, open_cap) expand into their
//     ccnt contiguous children, the next frontier, truncated at Wn;
//   * overfull deepest cells (last level): the first big_cap, cut into
//     16-particle chunk keys, into a buffer (walk) or the near list.
// Per chunk: each thread loads one node row (two 16-byte loads, com and
// mass and the integer fields, and bmax^2; the next chunk's rows are
// loaded while this one is classified) and classifies it with explicit
// round-to-nearest products and sums, in the order of fused_force.classify,
// so the decisions equal the plain version's; four warp ballots and a warp
// scan of the child counts give every output its place, with one
// __syncthreads per chunk (the per-warp totals are double-buffered). The
// running offsets are the same in every thread. At the end thread 0 writes
// the group's counts; in record mode it also updates the group's list
// counts and its telemetry (demand, drops), all integer, one block per
// group: no atomics. What bounds it on the H100: the bytes of the live
// frontier (ids and node rows) and of the compacted outputs.
//
// Periodic walk mode (periodic = 1, box, rcut: the TreePM split's short
// range; port of sidm_tpu/ops/fused_force.py:_classify's pbc branch
// :426-486, which JAX's periodic walk runs in XLA, not in its Pallas
// kernel): the bbox-to-COM distance is the minimum image of com - gc about
// the group box's centre gc, |delta| - half-width clamped at 0, delta -
// box * rint(delta / box) (rint rounds half to even, as torch.round and
// jnp.round do; roundf would not); and a cell with sqrt(r2b) > rcut +
// bmax is dropped (neither opened nor accepted: its force is all on the
// mesh). The same explicit roundings as the plain version's, so the
// decisions stay bit-equal. Walk mode only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBigMax = 64;     // big_cap limit (ops/far_kernel.py BIG_MAX)
constexpr int kT = 128;         // threads per block (measured against 256)

// Row layout of the counts (ops/far_kernel.py C_*).
enum { kFar, kSeg, kNext, kOpen, kOvfOpen, kBig, kBk, kBigDrop, kNCnt };
// Row layout of the record mode's telemetry (ops/far_kernel.py S_*).
enum { kNeedF, kNeedN, kOvfL, kOvfF, kOvfN };

struct Args {
    const float4* tbl;          // (cap, 4) float4: the level's pack_tree rows
    int nl_real;
    const int* fids;            // (ng, W) frontier, live prefix n_live
    const int* n_live;
    int W;
    const float* s_l;           // () cell size (+ 2 drift)
    const float* glo;           // (ng, 3)
    const float* ghi;
    const float* oac;           // (ng,) relative thresholds
    float theta2, leaf_cap;
    int mode, last;             // mode 0 geometric, 1 relative
    int O, Wn, big_cap, big_chunks;
    int lvl_base, LC;           // record: flat offset of the level, level cap
    int* far;                   // (ng, far_w)
    int far_w;
    int* seg;                   // (ng, seg_w)
    int seg_w;
    int* fids_next;             // (ng, Wn), null on the last level
    int* bkey;                  // walk, last level: (ng, big_cap*big_chunks)
    int* cnt;                   // (kNCnt, ng)
    int* nf;                    // record: (ng,) list counts, in and out
    int* nn;
    int* stat;                  // record: (5, ng) telemetry, added to
    int ng;
    float box, rcut;            // periodic walk mode
    int periodic;
};

struct Node {
    bool far, seg, open, big;
    int nstart, cnt, cstart, ccnt;
};

// The fields of node row `id` that classification reads (zeros when
// dead): com and mass, the integer fields, bmax^2.
struct Row {
    float4 r0, r1;
    float bmax2;
};

__device__ __forceinline__ Row load_row(const Args& a, int id) {
    Row r{make_float4(0.0f, 0.0f, 0.0f, 0.0f),
          make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0.0f};
    if (id >= 0 && id < a.nl_real) {
        const float4* p = a.tbl + (int64_t)id * 4;
        r.r0 = __ldg(p);
        r.r1 = __ldg(p + 1);
        r.bmax2 = __ldg(reinterpret_cast<const float*>(p) + 15);
    }
    return r;
}

// A row classified against the group box: explicit round-to-nearest
// products and sums, in the order of fused_force.classify (no FMA
// contraction, exact decisions).
// The periodic distance along one axis: |min image of c - gc| - hw,
// clamped at 0.
__device__ __forceinline__ float pbc_dx(float c, float gc, float hw,
                                        float box) {
    const float d = __fsub_rn(c, gc);
    const float q = __fmul_rn(rintf(__fdiv_rn(d, box)), box);
    return fmaxf(__fsub_rn(fabsf(__fsub_rn(d, q)), hw), 0.0f);
}

__device__ __forceinline__ Node classify(const Args& a, const Row& row,
                                         float s2, float s4, float lo0,
                                         float lo1, float lo2, float hi0,
                                         float hi1, float hi2, float oac) {
    const float4 r0 = row.r0, r1 = row.r1;
    float dx0, dx1, dx2;
    if (a.periodic) {
        // lo = group centre, hi = half-width in this mode (the caller's)
        dx0 = pbc_dx(r0.x, lo0, hi0, a.box);
        dx1 = pbc_dx(r0.y, lo1, hi1, a.box);
        dx2 = pbc_dx(r0.z, lo2, hi2, a.box);
    } else {
        dx0 = fmaxf(fmaxf(lo0 - r0.x, r0.x - hi0), 0.0f);
        dx1 = fmaxf(fmaxf(lo1 - r0.y, r0.y - hi1), 0.0f);
        dx2 = fmaxf(fmaxf(lo2 - r0.z, r0.z - hi2), 0.0f);
    }
    const float r2b = __fadd_rn(__fadd_rn(__fmul_rn(dx0, dx0),
                                          __fmul_rn(dx1, dx1)),
                                __fmul_rn(dx2, dx2));
    bool mac_open = s2 > __fmul_rn(a.theta2, r2b);
    if (a.mode == 1 && oac > 0.0f)
        mac_open = __fmul_rn(r0.w, s4) >
                   __fmul_rn(__fmul_rn(__fmul_rn(oac, r2b), r2b), r2b);
    mac_open = mac_open || (r2b <= row.bmax2);
    bool live = r1.x > 0.0f;
    if (a.periodic)
        live = live && (sqrtf(r2b) <= __fadd_rn(a.rcut, sqrtf(row.bmax2)));
    const bool is_leaf = r1.x <= a.leaf_cap;
    const bool deep = live && mac_open && !is_leaf;
    return Node{live && !mac_open, live && mac_open && is_leaf,
                deep && !a.last, deep && a.last, (int)r1.y, (int)r1.x,
                (int)r1.z, (int)r1.w};
}

__global__ void __launch_bounds__(kT) far_level_kernel(const Args a) {
    constexpr int kWarps = kT / 32;
    // per chunk and warp: far, seg, open, big counts and the child sum
    __shared__ int wt[2][kWarps][5];
    __shared__ int big_start[kBigMax], big_cnt[kBigMax];
    __shared__ int kept;        // children of the first O opened cells

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;
    float lo0 = a.glo[g * 3 + 0], lo1 = a.glo[g * 3 + 1],
          lo2 = a.glo[g * 3 + 2];
    float hi0 = a.ghi[g * 3 + 0], hi1 = a.ghi[g * 3 + 1],
          hi2 = a.ghi[g * 3 + 2];
    if (a.periodic) {
        // the box's centre and half-width, as the plain version rounds them
        const float c0 = __fmul_rn(0.5f, __fadd_rn(lo0, hi0));
        const float c1 = __fmul_rn(0.5f, __fadd_rn(lo1, hi1));
        const float c2 = __fmul_rn(0.5f, __fadd_rn(lo2, hi2));
        hi0 = __fmul_rn(0.5f, __fsub_rn(hi0, lo0));
        hi1 = __fmul_rn(0.5f, __fsub_rn(hi1, lo1));
        hi2 = __fmul_rn(0.5f, __fsub_rn(hi2, lo2));
        lo0 = c0;
        lo1 = c1;
        lo2 = c2;
    }
    const float s_l = *a.s_l;
    const float oac = a.oac[g];
    const float s2 = __fmul_rn(s_l, s_l);
    const float s4 = __fmul_rn(s2, s2);
    const bool record = a.nf != nullptr;
    const int nl = min(max(a.n_live[g], 0), a.W);
    const int f0 = record ? a.nf[g] : 0;      // list fill before the level
    const int n0 = record ? a.nn[g] : 0;
    const int* fg = a.fids + (int64_t)g * a.W;
    int* farg = a.far + (int64_t)g * a.far_w;
    int* segg = a.seg + (int64_t)g * a.seg_w;
    int* nxt = a.last ? nullptr : a.fids_next + (int64_t)g * a.Wn;
    if (tid == 0) kept = -1;

    // running totals before the current chunk (the same in every thread)
    int n_far = 0, n_seg = 0, n_open = 0, n_child = 0, n_big = 0;
    // two-deep prefetch: this chunk's rows and the next chunk's ids are
    // in flight while a chunk is classified and written
    int id = tid < nl ? __ldg(fg + tid) : -1;
    int id_next = kT + tid < nl ? __ldg(fg + kT + tid) : -1;
    Row row = load_row(a, id);
    for (int c0 = 0, buf = 0; c0 < nl; c0 += kT, buf ^= 1) {
        const Row row_next = load_row(a, id_next);
        const int id_after = c0 + 2 * kT + tid < nl
                                 ? __ldg(fg + c0 + 2 * kT + tid) : -1;
        const Node nd = classify(a, row, s2, s4, lo0, lo1, lo2, hi0, hi1,
                                 hi2, oac);
        const unsigned bf = __ballot_sync(0xffffffffu, nd.far);
        const unsigned bs = __ballot_sync(0xffffffffu, nd.seg);
        const unsigned bo = __ballot_sync(0xffffffffu, nd.open);
        const unsigned bb = __ballot_sync(0xffffffffu, nd.big);
        const int cc = nd.open ? nd.ccnt : 0;
        int cinc = cc;              // inclusive warp scan of child counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, cinc, o);
            if (lane >= o) cinc += y;
        }
        if (lane == 31) {
            wt[buf][warp][0] = __popc(bf);
            wt[buf][warp][1] = __popc(bs);
            wt[buf][warp][2] = __popc(bo);
            wt[buf][warp][3] = __popc(bb);
            wt[buf][warp][4] = cinc;
        }
        __syncthreads();
        int pre[5] = {0, 0, 0, 0, 0}, tot[5] = {0, 0, 0, 0, 0};
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                const int v = wt[buf][w][k];
                pre[k] += (w < warp) ? v : 0;
                tot[k] += v;
            }
        }
        if (nd.far) {
            const int p = n_far + pre[0] + __popc(bf & below);
            if (p < a.LC && f0 + p < a.far_w) farg[f0 + p] = a.lvl_base + id;
        }
        if (nd.seg) {
            const int p = n_seg + pre[1] + __popc(bs & below);
            if (p < a.LC && n0 + p < a.seg_w)
                segg[n0 + p] = nd.nstart * 32 + min(nd.cnt, 31);
        }
        if (nd.open) {
            const int r = n_open + pre[2] + __popc(bo & below);
            const int p = n_child + pre[4] + cinc - cc;
            if (r == a.O) kept = p;           // the first cell past the cap
            if (r < a.O) {
                for (int k = 0; k < cc && p + k < a.Wn; ++k)
                    nxt[p + k] = nd.cstart + k;
            }
        }
        if (nd.big) {
            const int r = n_big + pre[3] + __popc(bb & below);
            if (r < a.big_cap) {
                big_start[r] = nd.nstart;
                big_cnt[r] = nd.cnt;
            }
        }
        n_far += tot[0];
        n_seg += tot[1];
        n_open += tot[2];
        n_big += tot[3];
        n_child += tot[4];
        id = id_next;
        id_next = id_after;
        row = row_next;
    }
    __syncthreads();
    if (tid != 0) return;

    const int n_kids = kept >= 0 ? kept : n_child;
    const int ovf_open = a.last ? 0 : max(n_open - a.O, 0)
                                          + max(n_kids - a.Wn, 0);
    int nf1 = 0, nn1 = 0, ovf_f = 0, ovf_n = 0;
    if (record) {
        const int tf = min(n_far, a.LC), ts = min(n_seg, a.LC);
        nf1 = min(f0 + tf, a.far_w);
        nn1 = min(n0 + ts, a.seg_w);
        ovf_f = f0 + tf - nf1;
        ovf_n = n0 + ts - nn1;
    }
    // overfull deepest cells -> 16-particle chunks, in order
    int n_bk = 0, big_drop = 0;
    if (a.last) {
        int* dst = record ? segg + nn1 : a.bkey + (int64_t)g * a.big_cap
                                                    * a.big_chunks;
        const int room = record ? a.seg_w - nn1 : a.big_cap * a.big_chunks;
        for (int b = 0; b < min(n_big, a.big_cap); ++b) {
            const int c = big_cnt[b], s = big_start[b];
            for (int k = 0; k < a.big_chunks && 16 * k < c; ++k, ++n_bk)
                if (n_bk < room)
                    dst[n_bk] = (s + 16 * k) * 32 + min(c - 16 * k, 16);
            big_drop += max(c - 16 * a.big_chunks, 0);
        }
    }
    const int ng = a.ng;
    a.cnt[kFar * ng + g] = n_far;
    a.cnt[kSeg * ng + g] = n_seg;
    a.cnt[kNext * ng + g] = a.last ? 0 : min(n_kids, a.Wn);
    a.cnt[kOpen * ng + g] = n_open;
    a.cnt[kOvfOpen * ng + g] = ovf_open;
    a.cnt[kBig * ng + g] = n_big;
    a.cnt[kBk * ng + g] = n_bk;
    a.cnt[kBigDrop * ng + g] = big_drop;
    if (!record) return;
    const int nn2 = min(nn1 + n_bk, a.seg_w);
    const int over = max(n_big - a.big_cap, 0);
    a.stat[kNeedF * ng + g] += n_far;
    a.stat[kNeedN * ng + g] += n_seg + n_bk + over * a.big_chunks;
    a.stat[kOvfL * ng + g] += max(n_far - a.LC, 0) + max(n_seg - a.LC, 0)
                              + ovf_open + over + big_drop;
    a.stat[kOvfF * ng + g] += ovf_f;
    a.stat[kOvfN * ng + g] += ovf_n + nn1 + n_bk - nn2;
    a.nf[g] = nf1;
    a.nn[g] = nn2;
}

}  // namespace

// Walk mode: nf, nn and stat are null; far and seg are (ng, W) buffers
// (far_w = seg_w = W, LC = W, lvl_base = 0) and bkey the last level's
// chunk keys; periodic = 1 its periodic mode (box, rcut). Record mode: far and seg are the group lists (ng, LF) and
// (ng, LN), appended at nf and nn; bkey is null.
extern "C" int far_level_launch(const float* tbl, int nl_real,
                                const int* fids, const int* n_live, int ng,
                                int W, const float* s_l, const float* glo,
                                const float* ghi, const float* oac,
                                float theta2, int mode, float leaf_cap,
                                int last, int O, int Wn,
                                int big_cap, int big_chunks, int lvl_base,
                                int LC, int* far, int far_w, int* seg,
                                int seg_w, int* fids_next, int* bkey,
                                int* cnt, int* nf, int* nn, int* stat,
                                float box, float rcut, int periodic,
                                void* stream) {
    if (ng <= 0) return 0;
    if (big_cap > kBigMax) return (int)cudaErrorInvalidValue;
    if (periodic && nf) return (int)cudaErrorInvalidValue;   // walk mode
    const Args a{reinterpret_cast<const float4*>(tbl), nl_real, fids,
                 n_live, W, s_l, glo, ghi, oac, theta2, leaf_cap, mode, last,
                 O, Wn, big_cap, big_chunks, lvl_base, LC, far, far_w, seg,
                 seg_w, fids_next, bkey, cnt, nf, nn, stat, ng, box, rcut,
                 periodic};
    far_level_kernel<<<ng, kT, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
