// T2 and T3: SPH on the tree, the density sums and the hydro pair terms of
// each gas target over the particles of its group's walked segments. Ports
// of sidm_tpu/ops/fused_sph.py:_density_tile (:231-271) and _hydro_tile
// (:274-358) as _sph_near_level (:361-389) runs them over the walk's levels,
// plain XLA in the JAX package (no Pallas original); see
// sidm_tpu_torch/ops/fused_sph.py (tree_density_sums, tree_hydro_sums) for
// the contracts.
//
// Per live slot (a target with an id and h > 0) of a group, over every
// particle j of the group's segment keys start*32+cnt:
//  T2: the gas j with r < h (strict, self included): rho = sum m W(r/h)/h^3,
//      divv = -sum m dW/h^4 / r (d . dv), rot = sum m dW/h^4 / r (d x dv)
//      (r > 0) and the count; its count mode keeps only the count (the
//      smoothing-length controller's passes).
//  T3: the gas j != i with r < max(h_i, h_j): both halves of the
//      symmetrised pressure and Monaghan viscous force (Balsara switch, the
//      dW(h_i) half with i's viscosity limiter and the dW(h_j) half with
//      j's), acc and du/dt, and the pairs. Each target gathers its own
//      pair terms: no scatter, no atomics.
// d = x_i - x_j (the minimum image with a periodic box). Every float32 term
// is rounded as in the plain version (the file builds with -fmad=false,
// the same order of operations, true divisions), so that the counts are
// its own; the terms are summed in float64, in another order.
//
// Design (sidm_near.cu's, K4): one block of kThreads = 512 threads per work
// item (work_items.cuh): tree_weight gives each group its weight, (live
// slot, staged particle) pairs, and items_plan cuts every group into items
// of about equal pairs, each an even share of the group's keys. A block
// compacts its group's live slots with a ballot and gives each of its nlive
// slots tps = 512 / nlive threads. The keys are taken in rounds of up to
// kCap = 2048 particles (seg_rounds.cuh); each round's particles are
// staged in shared memory as one 16-byte entry each, read from the first
// 16 bytes of their row [x y z aux]: T2 stages (x, y, z, sorted id) and T3
// (x, y, z, h_j), with the id -1 (T2) or h -1 (T3) for a particle that is
// not gas, which the pair loop skips first (in a halo most particles are
// not). Thread q of a slot takes the staged particles q, q + tps, ...; a
// pair that passes reads the rest of its row from L2. Each thread keeps
// float64 partial sums; the tps partials of a slot are added in a fixed
// order (each lane of a warp a strided share, then a fixed shuffle tree)
// into the item's (64, W) float64 slot of the partial buffer, and
// items_fold adds a group's items in item order, so the result does not
// depend on the schedule. What bounds it on the H100: operations (bounds.py
// tree_density_work, tree_hydro_work).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "seg_rounds.cuh"
#include "sidm_pair.cuh"
#include "sph_kernel.cuh"
#include "work_items.cuh"

namespace {

using sidm_pair::min_image;

constexpr int kG = 64;                  // slots per group (fused_force G)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 2048;              // staged particles per round
constexpr int kStage = kCap / kThreads; // staged particles per thread
constexpr int kMaxSums = 5;             // float64 sums per slot
constexpr float kGamma = (float)(5.0 / 3.0);

struct Slots {                  // per group slot, (ng, 64[, 3 or 8])
    const float* gt;            // position
    const float* gv;            // velocity
    const float* gh;            // h (T2: (ng, 64); T3: column 0 of gq)
    int gh_stride;              // 1 (T2) or 8 (T3)
    const int* gidx;            // sorted id (-1: dead)
};

__device__ __forceinline__ bool live_slot(const Slots& sl, int slot) {
    return sl.gidx[slot] >= 0 && sl.gh[(int64_t)slot * sl.gh_stride] > 0.0f;
}

__device__ __forceinline__ bool is_gas(float aux) {
    // torch.remainder(aux, 8) == 0, as the plain version tests it
    return aux - floorf(aux / 8.0f) * 8.0f == 0.0f;
}

struct Partials {
    double s[kMaxSums][kThreads];
    int c[kThreads];
};

struct Shared {
    union {
        float4 p[kCap];         // x y z, id or h
        Partials part;
    };
    seg_rounds::Round<kCap> round;
    int live[kG];               // the live slots, compacted
    int nlive;
};

// Each group's weight: its staged particles times its live slots, one warp
// a group (ops/fused_range.py near_pairs is the plain version).
__global__ void __launch_bounds__(256)
tree_weight(const int* __restrict__ keys, const int* __restrict__ nn, int ng,
            int L, const Slots sl, int* __restrict__ w) {
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

// T2's pair terms. stage: the entry of sorted particle j; target: a live
// slot's constants; pair: one staged particle against them.
struct Density {
    static constexpr int kSums = 5;     // rho, divv, rot xyz; then the count
    const float4* __restrict__ rows;    // (n, 2): [x y z aux | v xyz m]
    bool count_only;

    __device__ __forceinline__ float4 stage(int j) const {
        const float4 r = __ldg(rows + 2 * (int64_t)j);
        return make_float4(r.x, r.y, r.z,
                           __int_as_float(is_gas(r.w) ? j : -1));
    }

    struct Target {
        float x, y, z, vx, vy, vz, h, hb, h3, h4;
        int me;
    };

    __device__ __forceinline__ Target target(const Slots& sl, int slot) const {
        Target t;
        t.x = sl.gt[slot * 3 + 0];
        t.y = sl.gt[slot * 3 + 1];
        t.z = sl.gt[slot * 3 + 2];
        t.vx = sl.gv[slot * 3 + 0];
        t.vy = sl.gv[slot * 3 + 1];
        t.vz = sl.gv[slot * 3 + 2];
        t.h = sl.gh[slot];
        t.hb = fmaxf(t.h, 1e-30f);
        const float h2 = t.hb * t.hb;
        t.h3 = h2 * t.hb;
        t.h4 = h2 * h2;
        t.me = sl.gidx[slot];
        return t;
    }

    template <bool kBox>
    __device__ __forceinline__ void pair(const Target& t, float4 b, int,
                                         const seg_rounds::Round<kCap>&,
                                         float box, double* s, int& c) const {
        const int j = __float_as_int(b.w);
        if (j < 0) return;                       // not gas
        const float d0 = min_image(t.x - b.x, kBox ? box : 0.0f);
        const float d1 = min_image(t.y - b.y, kBox ? box : 0.0f);
        const float d2 = min_image(t.z - b.z, kBox ? box : 0.0f);
        const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
        if (!(r < t.h)) return;
        ++c;
        if (count_only) return;
        const float4 v = __ldg(rows + 2 * (int64_t)j + 1);
        const float u = r / t.hb;
        const float wk = sph_kernel::w(u) / t.h3;
        const float dwk = sph_kernel::dw(u) / t.h4;
        s[0] += (double)(v.w * wk);
        if (!(r > 0.0f)) return;
        const float fac = v.w * dwk / fmaxf(r, 1e-30f);
        const float w0 = t.vx - v.x, w1 = t.vy - v.y, w2 = t.vz - v.z;
        s[1] -= (double)(fac * (d0 * w0 + d1 * w1 + d2 * w2));
        s[2] += (double)(fac * (d1 * w2 - d2 * w1));
        s[3] += (double)(fac * (d2 * w0 - d0 * w2));
        s[4] += (double)(fac * (d0 * w1 - d1 * w0));
    }
};

struct Factors {
    int comoving;
    float half, half_egy, fac_visc_fix, sqrt_a, hubble_a, mu_fac;
    float nabv, abv2;           // -ArtBulkViscConst, 2 ArtBulkViscConst
};

// T3's pair terms (rows (n, 4) float4: [x y z aux | v xyz m | h rho csnd
// f_balsara | dt 0 0 0]; gq (ng, 64, 8) [h m rho P/rho^2 csnd f_balsara
// dt 0]).
struct Hydro {
    static constexpr int kSums = 4;     // acc xyz, dt_egy; then the pairs
    const float4* __restrict__ rows;
    const float* __restrict__ gq;
    Factors f;

    __device__ __forceinline__ float4 stage(int j) const {
        const float4 r = __ldg(rows + 4 * (int64_t)j);
        const float h = __ldg(reinterpret_cast<const float*>(rows)
                              + 16 * (int64_t)j + 8);
        return make_float4(r.x, r.y, r.z, is_gas(r.w) ? h : -1.0f);
    }

    struct Target {
        float x, y, z, vx, vy, vz, h, hb, h4, m, rho, por2, cs, fb, dt;
        int me;
    };

    __device__ __forceinline__ Target target(const Slots& sl, int slot) const {
        Target t;
        t.x = sl.gt[slot * 3 + 0];
        t.y = sl.gt[slot * 3 + 1];
        t.z = sl.gt[slot * 3 + 2];
        t.vx = sl.gv[slot * 3 + 0];
        t.vy = sl.gv[slot * 3 + 1];
        t.vz = sl.gv[slot * 3 + 2];
        const float* q = gq + 8 * (int64_t)slot;
        t.h = q[0];
        t.m = q[1];
        t.rho = q[2];
        t.por2 = q[3];
        t.cs = q[4];
        t.fb = q[5];
        t.dt = q[6];
        t.hb = fmaxf(t.h, 1e-30f);
        const float h2 = t.hb * t.hb;
        t.h4 = h2 * h2;
        t.me = sl.gidx[slot];
        return t;
    }

    // the viscosity of one half, limited where the pair approaches
    // (hydra.c:296-308)
    __device__ __forceinline__ float limited(float visc, float dwk, float dt,
                                             float vdotr2, float msum,
                                             float r_safe, bool app) const {
        const float den = dwk < 0.0f
                              ? msum * (2.0f * dwk) * r_safe
                                    * fmaxf(dt, 1e-30f)
                              : -1e30f;
        const float lim = f.fac_visc_fix * vdotr2 / den;
        return (app && dt > 1e-30f && dwk < 0.0f) ? fminf(visc, lim) : visc;
    }

    template <bool kBox>
    __device__ __forceinline__ void pair(const Target& t, float4 b, int k,
                                         const seg_rounds::Round<kCap>& R,
                                         float box, double* s, int& c) const {
        const float hj = b.w;
        if (hj < 0.0f) return;                   // not gas
        const float d0 = min_image(t.x - b.x, kBox ? box : 0.0f);
        const float d1 = min_image(t.y - b.y, kBox ? box : 0.0f);
        const float d2 = min_image(t.z - b.z, kBox ? box : 0.0f);
        const float r2 = d0 * d0 + d1 * d1 + d2 * d2;
        const float r = sqrtf(r2);
        const float hbj = fmaxf(hj, 1e-30f);
        const bool ok_i = r < t.hb, ok_j = r < hbj;
        if (!(ok_i || ok_j)) return;
        const int j = seg_rounds::staged_id(R, k);
        if (j == t.me) return;
        ++c;
        const float4 v = __ldg(rows + 4 * (int64_t)j + 1);
        const float4 q = __ldg(rows + 4 * (int64_t)j + 2);
        const float dt_j = __ldg(reinterpret_cast<const float*>(rows)
                                 + 16 * (int64_t)j + 12);
        const float hj2 = hbj * hbj;
        const float dwk_i = ok_i ? sph_kernel::dw(r / t.hb) / t.h4 : 0.0f;
        const float dwk_j = ok_j ? sph_kernel::dw(r / hbj) / (hj2 * hj2)
                                 : 0.0f;
        const float w0 = t.vx - v.x, w1 = t.vy - v.y, w2 = t.vz - v.z;
        float vdotr2 = d0 * w0 + d1 * w1 + d2 * w2;
        if (f.comoving) vdotr2 = vdotr2 / f.sqrt_a + f.hubble_a * r2;
        const float h_ij = 0.5f * (t.h + q.x);
        const float c_ij = 0.5f * (t.cs + q.z);
        const float rho_ij = 0.5f * (t.rho + q.y);
        float mu = h_ij * vdotr2 / (r2 + 0.01f * h_ij * h_ij);
        if (f.comoving) mu = mu * f.mu_fac;
        const float f_ij = 0.5f * (t.fb + q.w);
        const bool app = vdotr2 < 0.0f;
        const float visc =
            app ? (f.nabv * mu * c_ij + f.abv2 * mu * mu)
                      / fmaxf(rho_ij, 1e-30f) * f_ij
                : 0.0f;
        const float msum = 0.5f * (t.m + v.w);
        const float r_safe = fmaxf(r, 1e-30f);
        const float visc_i = limited(visc, dwk_i, t.dt, vdotr2, msum,
                                     r_safe, app);
        const float visc_j = limited(visc, dwk_j, dt_j, vdotr2, msum,
                                     r_safe, app);
        const float p_or2_j = (q.z * q.z) / (kGamma * fmaxf(q.y, 1e-30f));
        const float pp = 2.0f * sqrtf(fmaxf(t.por2 * p_or2_j, 0.0f));
        const float hfc = f.half * v.w
                          * ((pp + visc_i) * dwk_i + (pp + visc_j) * dwk_j)
                          / r_safe;
        s[0] -= (double)(hfc * d0);
        s[1] -= (double)(hfc * d1);
        s[2] -= (double)(hfc * d2);
        s[3] += (double)(f.half_egy * hfc * vdotr2);
    }
};

// One work item: the item's keys of group g against the group's live
// slots; writes the live slots' (kSums sums, count) into the item's (64,
// kSums + 1) float64 slot of part.
template <class Op, bool kBox>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
tree_sph_kernel(const int* __restrict__ item_g, const int* __restrict__ off,
                int ng, const int* __restrict__ keys,
                const int* __restrict__ nn, int L, const Slots sl, Op op,
                float box, double* __restrict__ part) {
    constexpr int W = Op::kSums + 1;
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
        for (int e = 0; e < 2; ++e)
            lv[e] = live_slot(sl, g * kG + lane + 32 * e);
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
    const int tps = kThreads / nlive;   // threads per live slot
    const int si = t / tps, q = t - si * tps;
    const bool act = si < nlive;
    typename Op::Target tg{};
    if (act) tg = op.target(sl, g * kG + S.live[si]);
    double s[Op::kSums] = {};
    int c = 0;
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
            float4 e[kStage];
#pragma unroll
            for (int i = 0; i < kStage; ++i) {
                const int p = t + i * kThreads;
                if (p < total)
                    e[i] = op.stage(seg_rounds::staged_id(S.round, p));
            }
#pragma unroll
            for (int i = 0; i < kStage; ++i)
                if (t + i * kThreads < total) S.p[t + i * kThreads] = e[i];
        }
        __syncthreads();
        if (act)
            for (int k = q; k < total; k += tps)
                op.template pair<kBox>(tg, S.p[k], k, S.round, box, s, c);
        __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < Op::kSums; ++k) S.part.s[k][t] = s[k];
    S.part.c[t] = c;
    __syncthreads();
    // warp w combines the slots w, w + kWarps, ...: lane l adds the
    // partials l, l + 32, ... of the slot's tps, then a fixed shuffle tree
    for (int sg = warp; sg < nlive; sg += kWarps) {
        double a[Op::kSums] = {};
        int cn = 0;
        for (int e = lane; e < tps; e += 32) {
            const int u = sg * tps + e;
#pragma unroll
            for (int k = 0; k < Op::kSums; ++k) a[k] += S.part.s[k][u];
            cn += S.part.c[u];
        }
#pragma unroll
        for (int k = 0; k < Op::kSums; ++k) a[k] = sph_kernel::warp_sum(a[k]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            cn += __shfl_xor_sync(0xffffffffu, cn, o);
        if (lane == 0) {
            double* dst = part + ((int64_t)it * kG + S.live[sg]) * W;
#pragma unroll
            for (int k = 0; k < Op::kSums; ++k) dst[k] = a[k];
            dst[Op::kSums] = (double)cn;
        }
    }
}

// items_fold's pass, on blocks of kG threads: slot c of group g gets its
// items' W values added in item order; a dead slot, or one of a group
// without items, gets zeros.
struct Fold {
    const double* __restrict__ part;
    Slots sl;
    int W;
    double* __restrict__ out;
    __device__ __forceinline__ void operator()(int g, int c, int a,
                                               int b) const {
        const int slot = g * kG + c;
        if (!live_slot(sl, slot)) b = a;
        double v[kMaxSums + 1] = {};
        for (int i = a; i < b; ++i)
            for (int k = 0; k < W; ++k)
                v[k] += part[((int64_t)i * kG + c) * W + k];
        for (int k = 0; k < W; ++k) out[(int64_t)slot * W + k] = v[k];
    }
};

template <class Op>
int launch(const int* keys, const int* nn, int ng, int L, const Slots& sl,
           const Op& op, float box, int p_min, int icap, int* w, int* ws,
           double* part, double* out, cudaStream_t st) {
    if (ng <= 0) return 0;
    const items::Ws it = items::ws_of(ws, ng, icap, false);
    tree_weight<<<(ng * 32 + 255) / 256, 256, 0, st>>>(keys, nn, ng, L, sl,
                                                      w);
    items::items_plan<<<1, items::kPlanThreads, 0, st>>>(
        w, items::kImax, ng, icap, p_min, it.unit, it.off, it.item_g);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (box > 0.0f)
        tree_sph_kernel<Op, true><<<icap, kThreads, 0, st>>>(
            it.item_g, it.off, ng, keys, nn, L, sl, op, box, part);
    else
        tree_sph_kernel<Op, false><<<icap, kThreads, 0, st>>>(
            it.item_g, it.off, ng, keys, nn, L, sl, op, box, part);
    if ((err = (int)cudaGetLastError())) return err;
    items::items_fold<<<ng, kG, 0, st>>>(
        it.off, Fold{part, sl, Op::kSums + 1, out});
    return (int)cudaGetLastError();
}

}  // namespace

// T2. keys (ng, L) segment keys with live counts nn; rows (n, 8) float32
// sorted [x y z aux | vx vy vz m]; gt, gv (ng, 64, 3), gh (ng, 64), gidx
// (ng, 64); box the periodic box (0: none); count_only: the count mode;
// p_min the least (live slot, staged particle) pairs of an item, icap the
// most items (ops/work_items.py item_cap), w (ng,) int32 scratch, ws the
// items' int32 workspace (ws_size(ng, icap, False)) and part their (icap,
// 64, 6) float64 partials; out (ng, 64, 6) float64 [rho divv rot xyz
// count], every slot written (zeros where no live target).
extern "C" int tree_density_launch(const int* keys, const int* nn, int ng,
                                   int L, const float* rows, const float* gt,
                                   const float* gv, const float* gh,
                                   const int* gidx, float box, int count_only,
                                   int p_min, int icap, int* w, int* ws,
                                   double* part, double* out, void* stream) {
    const Slots sl{gt, gv, gh, 1, gidx};
    const Density op{reinterpret_cast<const float4*>(rows), count_only != 0};
    return launch(keys, nn, ng, L, sl, op, box, p_min, icap, w, ws, part,
                  out, (cudaStream_t)stream);
}

// T3. keys, nn as T2; rows (n, 16) float32 sorted [x y z aux | vx vy vz m
// | h rho csnd f_balsara | dt 0 0 0]; gt, gv (ng, 64, 3), gq (ng, 64, 8)
// [h m rho P/rho^2 csnd f_balsara dt 0], gidx (ng, 64); the pair factors;
// the items' buffers as T2's with (icap, 64, 5) partials; out (ng, 64, 5)
// float64 [acc xyz, dt_egy, pairs].
extern "C" int tree_hydro_launch(const int* keys, const int* nn, int ng,
                                 int L, const float* rows, const float* gt,
                                 const float* gv, const float* gq,
                                 const int* gidx, float box, int comoving,
                                 float prefac, float fac_visc_fix,
                                 float egy_fac, float sqrt_a, float hubble_a,
                                 float mu_fac, float art_bulk_visc,
                                 int p_min, int icap, int* w, int* ws,
                                 double* part, double* out, void* stream) {
    const Slots sl{gt, gv, gq, 8, gidx};
    Factors f;
    f.comoving = comoving;
    f.half = prefac * 0.5f;
    f.half_egy = 0.5f * egy_fac;
    f.fac_visc_fix = fac_visc_fix;
    f.sqrt_a = sqrt_a;
    f.hubble_a = hubble_a;
    f.mu_fac = mu_fac;
    f.nabv = -art_bulk_visc;
    f.abv2 = 2.0f * art_bulk_visc;
    const Hydro op{reinterpret_cast<const float4*>(rows), gq, f};
    return launch(keys, nn, ng, L, sl, op, box, p_min, icap, w, ws, part,
                  out, (cudaStream_t)stream);
}
