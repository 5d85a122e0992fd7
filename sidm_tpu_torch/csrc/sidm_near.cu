// The DSMC pass over the range walk's segments (K4): per gated target, the
// kernel-weighted pair probabilities against the particles of its group's
// walked segments, their sum, the neighbour count and the Gumbel-max
// partner. Port of sidm_tpu/ops/fused_range.py:_sidm_near_tile (:127) as
// _sidm_near_level (:207) drives it over the walk's levels, plain XLA in
// the JAX package (no Pallas original); see
// sidm_tpu_torch/ops/fused_range.py (sidm_near) for the contract.
//
// One block of kThreads = 512 threads per work item (work_items.cuh):
// near_weight gives each group its weight, (live slot, staged particle)
// pairs, and items_plan cuts every group into items of about equal pairs,
// each an even share of the group's keys. The halo's core gives a few groups up
// to 186k staged particles against all 64 slots, 12M pairs, more than a
// tenth of all, so a block per group would leave those to set the
// kernel's time alone. Every item writes its live slots' partials to its
// own (64, 4) slot of the partial buffer, and items_fold (NearFold) folds
// a group's items in item order and writes every slot, so the result does
// not depend on the schedule.
//
// The gated windows leave a group only ~13 live slots (gidx >= 0 and h > 0)
// of 64, so a block first compacts its live slots with a ballot and gives
// each of its nlive live slots tps = 512 / nlive threads; the fold gives the
// other slots (0, 0, -inf, -1). The keys start*32+cnt (cnt <= 31) are taken
// in rounds of up to kCap = 2048 particles (seg_rounds.cuh); each round's
// particles are staged in shared memory as one 16-byte entry each (x, y, z
// and the sorted id), read with one 16-byte load from the row [pos3 vel3 mass
// aux], by every thread at once. Thread q of a slot takes the staged
// particles q, q + tps, ..., kBatch at a time. Per pair: d = x_i - x_j
// (minimum image with a periodic box) and r^2; only r^2 < t(h), the least
// float whose rounded root reaches h (sidm_pair.cuh, sqrt_lt_bound: the same
// decisions as r = sqrt(r^2) < h), goes on, out of line (near_pair): then j
// != i, the partner's row read from L2 for its type, pending flag, velocity
// and mass, and for a partner of the same type with no pending kick P_j = 0.5
// m_j W(r/h)/h^3 sigma(v) v dt and the key log(max(P_j, 1e-37)) + Gumbel(i,
// j, salt) for P_j > 0. The pair math is the gated tile's (sidm_pair.cuh),
// rounded one operation at a time (the file builds with -fmad=false), so a
// key equals the plain version's bit for bit. The tps partial sums, counts
// and (key, id) maxima of a slot are combined in shared memory in a fixed
// order (each lane of a warp folds a strided share, then a fixed shuffle
// tree), the larger sorted id winning on equal keys (the sum is taken in
// another order than the plain version's). What bounds it on the H100:
// operations, about 46 per live pair and 12 per other (live slot, segment
// particle) pair; each staged particle is read once per item.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seg_rounds.cuh"
#include "sidm_pair.cuh"
#include "work_items.cuh"

namespace {

using sidm_pair::min_image;
using sidm_pair::pair_key;
using sidm_pair::pair_prob;
using sidm_pair::Sigma;

constexpr int kG = 64;                  // slots per group (fused_force G)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 2048;              // staged particles per round
constexpr int kStage = kCap / kThreads; // staged particles per thread
constexpr int kBatch = 4;               // staged particles a thread tests
                                        // before it takes their hits

struct Slots {                  // per group slot, (ng, 64[, 3])
    const float* gt;            // position
    const float* gv;            // velocity
    const float* gh;            // search radius h (0: not gated)
    const float* gdt;           // dt_h0
    const int* gty;             // type (-9: dead)
    const int* gidx;            // sorted id (-1: dead)
};

struct Partials {                // per-thread partials, after the rounds
    float psum[kThreads];
    int cn[kThreads];
    float bk[kThreads];
    int bj[kThreads];
};

struct Shared {
    union {
        float4 p[kCap];         // x y z, sorted id (bits)
        Partials part;
    };
    seg_rounds::Round<kCap> round;
    int live[kG];               // the live slots, compacted
    int nlive;
};

__device__ __forceinline__ bool better(float k, int j, float bk, int bj) {
    return k > bk || (k == bk && j > bj);
}

struct Pair {
    float prob, key;            // P_j and its key (-inf for P_j = 0)
    bool ok;                    // same type, partner not pending
};

// A pair within h (rr < t(h)) and j != i: the partner's row [vel3 mass
// aux] read from L2, its test and its probability and key. Out of line:
// the pair loop stays small, and few pairs come here.
__device__ __noinline__ Pair near_pair(const float4* __restrict__ rows,
                                       int j, float rr, int me, int typ,
                                       float vx, float vy, float vz, float h,
                                       float h3, float tdt, uint32_t salt,
                                       Sigma sigma) {
    const float4 b1 = __ldg(rows + (int64_t)j * 2 + 1);
    const int aux = (int)b1.w;
    if (aux >= 8 || (aux & 7) != typ) return Pair{0.0f, -INFINITY, false};
    const float vjx = __ldg(reinterpret_cast<const float*>(rows)
                            + (int64_t)j * 8 + 3);
    const float prob = pair_prob(sqrtf(rr), h, h3, vx - vjx, vy - b1.x,
                                 vz - b1.y, b1.z, tdt, sigma);
    return Pair{prob, prob > 0.0f ? pair_key(prob, (uint32_t)me,
                                             (uint32_t)j, salt)
                                  : -INFINITY, true};
}

__device__ __forceinline__ bool live_slot(const Slots& sl, int slot) {
    return sl.gidx[slot] >= 0 && sl.gh[slot] > 0.0f;
}

// Each group's weight: its staged particles (warp_cover) times its live
// slots, one warp a group (ops/fused_range.py near_pairs is the plain
// version).
__global__ void __launch_bounds__(256)
near_weight(const int* __restrict__ keys, const int* __restrict__ nn,
            int ng, int L, const Slots sl, int* __restrict__ w) {
    const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (g >= ng) return;
    const int cov = items::warp_cover(keys + (int64_t)g * L,
                                      min(max(nn[g], 0), L), lane);
    const int live =
        __popc(__ballot_sync(0xffffffffu, live_slot(sl, g * kG + lane)))
        + __popc(__ballot_sync(0xffffffffu,
                               live_slot(sl, g * kG + lane + 32)));
    if (lane == 0)
        w[g] = (int)min((long long)cov * live, (long long)items::kImax);
}

template <bool kBox>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
sidm_near_kernel(const int* __restrict__ item_g, const int* __restrict__ off,
                 int ng, const int* __restrict__ keys,
                 const int* __restrict__ nn, int L,
                 const float4* __restrict__ rows, const Slots sl,
                 uint32_t salt, Sigma sigma, float box,
                 float4* __restrict__ part) {
    __shared__ Shared S;
    const int it = blockIdx.x;
    if (it >= off[ng]) return;          // past the plan's last item
    const int g = item_g[it];
    const int piece = it - off[g], np = off[g + 1] - off[g];
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;

    if (warp == 0) {
        // compact the live slots
        bool lv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            lv[e] = live_slot(sl, g * kG + lane + 32 * e);
        }
        const unsigned m0 = __ballot_sync(0xffffffffu, lv[0]);
        const unsigned m1 = __ballot_sync(0xffffffffu, lv[1]);
        const unsigned lower = (1u << lane) - 1u;
        if (lv[0]) S.live[__popc(m0 & lower)] = lane;
        if (lv[1]) S.live[__popc(m0) + __popc(m1 & lower)] = lane + 32;
        if (lane == 0) S.nlive = __popc(m0) + __popc(m1);
    }
    __syncthreads();
    const int nlive = S.nlive;
    if (nlive == 0) return;             // no item has weight 0
    const int tps = kThreads / nlive;     // threads per live slot
    const int si = t / tps, q = t - si * tps;
    const bool act = si < nlive;

    float tx = 0.0f, ty = 0.0f, tz = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
    float th = 0.0f, tdt = 0.0f;
    int me = -1, typ = -9;
    if (act) {
        const int slot = g * kG + S.live[si];
        tx = sl.gt[slot * 3 + 0];
        ty = sl.gt[slot * 3 + 1];
        tz = sl.gt[slot * 3 + 2];
        vx = sl.gv[slot * 3 + 0];
        vy = sl.gv[slot * 3 + 1];
        vz = sl.gv[slot * 3 + 2];
        th = sl.gh[slot];
        tdt = sl.gdt[slot];
        typ = sl.gty[slot];
        me = sl.gidx[slot];
    }
    const float lim = sidm_pair::sqrt_lt_bound(th);   // 0 when inactive
    const float h = fmaxf(th, 1e-30f);
    const float h3 = h * h * h;
    float psum = 0.0f, bk = -INFINITY;
    int cn = 0, bj = -1;
    // this item's keys: [piece * nk / np, (piece + 1) * nk / np)
    const int nkg = min(max(nn[g], 0), L);
    const int k_lo = (int)((int64_t)piece * nkg / np);
    const int nk = (int)((int64_t)(piece + 1) * nkg / np) - k_lo;
    const int* kg = keys + (int64_t)g * L + k_lo;

    int key = seg_rounds::next_key(kg, 0, nk, t);
    for (int c0 = 0; c0 < nk;) {
        const int taken = seg_rounds::plan<kCap>(S.round, key, c0, nk, t);
        const int total = S.round.off[taken];
        c0 += taken;
        key = seg_rounds::next_key(kg, c0, nk, t);
        {
            // every thread stages kStage particles, their loads in flight
            // together
            int j[kStage];
            float4 r0[kStage];
#pragma unroll
            for (int i = 0; i < kStage; ++i) {
                const int p = t + i * kThreads;
                j[i] = p < total ? seg_rounds::staged_id(S.round, p) : -1;
                if (j[i] >= 0) r0[i] = __ldg(rows + (int64_t)j[i] * 2);
            }
#pragma unroll
            for (int i = 0; i < kStage; ++i)
                if (j[i] >= 0)
                    S.p[t + i * kThreads] = make_float4(
                        r0[i].x, r0[i].y, r0[i].z, __int_as_float(j[i]));
        }
        __syncthreads();
        if (act) {
            for (int k = q; k < total; k += kBatch * tps) {
                // kBatch particles' r^2 first (a NaN past the round: no
                // hit), then their hits
                float4 b[kBatch];
                float rr[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int kk = k + u * tps;
                    b[u] = kk < total ? S.p[kk]
                                      : make_float4(NAN, 0.0f, 0.0f, 0.0f);
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const float d0 = min_image(tx - b[u].x,
                                               kBox ? box : 0.0f);
                    const float d1 = min_image(ty - b[u].y,
                                               kBox ? box : 0.0f);
                    const float d2 = min_image(tz - b[u].z,
                                               kBox ? box : 0.0f);
                    rr[u] = d0 * d0 + d1 * d1 + d2 * d2;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int j = __float_as_int(b[u].w);
                    if (!(rr[u] < lim) || j == me) continue;
                    const Pair pr = near_pair(rows, j, rr[u], me, typ, vx,
                                              vy, vz, h, h3, tdt, salt,
                                              sigma);
                    if (!pr.ok) continue;
                    ++cn;
                    psum += pr.prob;
                    if (pr.prob > 0.0f && better(pr.key, j, bk, bj)) {
                        bk = pr.key;
                        bj = j;
                    }
                }
            }
        }
        __syncthreads();
    }
    S.part.psum[t] = psum;
    S.part.cn[t] = cn;
    S.part.bk[t] = bk;
    S.part.bj[t] = bj;
    __syncthreads();
    // warp w combines the slots w, w + kWarps, ...: lane l folds the partials
    // l, l + 32, ... of the slot's tps, then a fixed shuffle tree
    for (int s = warp; s < nlive; s += kWarps) {
        float a = 0.0f, k = -INFINITY;
        int c = 0, jb = -1;
        for (int e = lane; e < tps; e += 32) {
            const int u = s * tps + e;
            a += S.part.psum[u];
            c += S.part.cn[u];
            if (better(S.part.bk[u], S.part.bj[u], k, jb)) {
                k = S.part.bk[u];
                jb = S.part.bj[u];
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, o);
            c += __shfl_xor_sync(0xffffffffu, c, o);
            const float ok = __shfl_xor_sync(0xffffffffu, k, o);
            const int oj = __shfl_xor_sync(0xffffffffu, jb, o);
            if (better(ok, oj, k, jb)) {
                k = ok;
                jb = oj;
            }
        }
        if (lane == 0)
            part[(int64_t)it * kG + S.live[s]] = make_float4(
                a, __int_as_float(c), k, __int_as_float(jb));
    }
}

// items_fold's pass, on blocks of kG threads: slot c of group g gets its
// items' partials folded in item order (sums added, the larger (key, id)
// kept); a dead or ungated slot, or one of a group without items, gets
// (0, 0, -inf, -1).
struct NearFold {
    const float4* __restrict__ part;
    Slots sl;
    float* __restrict__ ptot;
    int* __restrict__ ncnt;
    float* __restrict__ bestk;
    int* __restrict__ bestj;
    __device__ __forceinline__ void operator()(int g, int c, int a,
                                               int b) const {
        const int slot = g * kG + c;
        if (!live_slot(sl, slot)) b = a;
        float sum = 0.0f, k = -INFINITY;
        int cn = 0, jb = -1;
        for (int i = a; i < b; ++i) {
            const float4 p = part[(int64_t)i * kG + c];
            sum += p.x;
            cn += __float_as_int(p.y);
            if (better(p.z, __float_as_int(p.w), k, jb)) {
                k = p.z;
                jb = __float_as_int(p.w);
            }
        }
        ptot[slot] = sum;
        ncnt[slot] = cn;
        bestk[slot] = k;
        bestj[slot] = isfinite(k) ? jb : -1;
    }
};

}  // namespace

// keys (ng, L) segment keys with live counts nn; rows (n, 8) float32
// sorted [pos3 vel3 mass aux]; gt, gv (ng, 64, 3), gh, gdt, gty, gidx (ng,
// 64); box the periodic box (0: none); p_min the least (live slot,
// staged particle) pairs of an item, icap the most items
// (ops/work_items.py item_cap), w (ng,) int32 scratch for the groups'
// pairs, ws the items' int32 workspace (ws_size(ng, icap, False)) and
// part their (icap, 64, 4) float32 partials; outputs (ng, 64), every slot written (0, 0, -inf, -1 where
// nothing scatters).
extern "C" int sidm_near_launch(const int* keys, const int* nn, int ng,
                                int L, const float* rows, int n,
                                const float* gt, const float* gv,
                                const float* gh, const float* gdt,
                                const int* gty, const int* gidx,
                                unsigned salt, int cs_type, float sigma_co,
                                float vc, float vel_scale, float pow_law,
                                float box, int p_min, int icap, int* w,
                                int* ws, float* part, float* ptot, int* ncnt,
                                float* bestk, int* bestj, void* stream) {
    (void)n;
    if (ng <= 0) return 0;
    const Sigma sigma{cs_type, sigma_co, vc, vel_scale, pow_law};
    const Slots sl{gt, gv, gh, gdt, gty, gidx};
    const items::Ws it = items::ws_of(ws, ng, icap, false);
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    float4* p4 = reinterpret_cast<float4*>(part);
    const cudaStream_t st = (cudaStream_t)stream;
    near_weight<<<(ng * 32 + 255) / 256, 256, 0, st>>>(keys, nn, ng, L, sl,
                                                      w);
    items::items_plan<<<1, items::kPlanThreads, 0, st>>>(
        w, items::kImax, ng, icap, p_min, it.unit, it.off, it.item_g);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (box > 0.0f)
        sidm_near_kernel<true><<<icap, kThreads, 0, st>>>(
            it.item_g, it.off, ng, keys, nn, L, r4, sl, (uint32_t)salt,
            sigma, box, p4);
    else
        sidm_near_kernel<false><<<icap, kThreads, 0, st>>>(
            it.item_g, it.off, ng, keys, nn, L, r4, sl, (uint32_t)salt,
            sigma, box, p4);
    if ((err = (int)cudaGetLastError())) return err;
    items::items_fold<<<ng, kG, 0, st>>>(
        it.off, NearFold{p4, sl, ptot, ncnt, bestk, bestj});
    return (int)cudaGetLastError();
}
