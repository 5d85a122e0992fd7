// SIDM candidate emission: every group's targets tested against the
// particles of the group's recorded range segments. Port of
// sidm_tpu/ops/list_range.py:_emit_candidates (:205-317), plain XLA in the
// JAX package (no Pallas original); see sidm_tpu_torch/ops/list_range.py
// for the contract.
//
// One block of kThreads = 512 threads per target group (kG = 64 slots), the
// groups taken in the order the wrapper gives (most staged particles first,
// as JAX length-sorts its groups). The group's segment keys are taken in
// rounds of up to kCap = 2048 particles (seg_rounds.cuh); each round's
// particles (start..start+cnt-1, cnt <= 31) are staged in shared memory as
// structure of arrays (x, y, z, type code, sorted id), in key order then
// particle order, every thread loading four at once. While it stages them,
// each warp takes the box of a batch of 32 staged particles (warp min/max)
// and marks the slots whose radius may reach it; a (slot, batch) pair that
// cannot hit is skipped, and the test that skips it keeps a margin far above
// the rounding of both distances, so no hit is lost. Warp w owns the slots w,
// w + 16, w + 32, w + 48 and takes each against the batches it may reach, 32
// staged particles at a time, one per lane: a hit is the same type, not
// itself and r^2 < R^2; __ballot_sync gives the hits, and a hit's place in
// the row is the row's count plus __popc of the hits on lower lanes, so every
// row receives its ids in the staged order (which decides the K a truncated
// list keeps) with no atomics and no second pass, and all hits are counted
// (the uncapped demand); the wrapper fills cand with IMAX before the launch.
// Count mode (the hsml init's neighbour count,
// sidm_tpu/ops/fused_range.py:179-183) counts the non-pending hits with
// sqrt(r^2) < h in each lane (no ballot), summed by a shuffle tree at the
// end; its test is r^2 < t(h), the least float whose rounded root reaches h
// (sidm_pair.cuh, sqrt_lt_bound, found once a slot), so the pair loop takes
// no root and decides as __fsqrt_rn(r^2) < h does. Products and sums are
// rounded one by one as the plain version rounds them (the file builds with
// -fmad=false), so every decision is the plain version's. With a periodic box
// (box > 0) each difference is taken by the minimum image, and no batch is
// skipped. What bounds it on the H100: operations, about 11 per (target,
// staged particle) pair of the batches the target may reach and the box tests
// (bounds.py emit_work), and in record mode the bytes of the whole (n, K)
// output; each staged particle is read once per group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_rounds.cuh"
#include "sidm_pair.cuh"

namespace {

constexpr int kG = 64;                  // slots per group (fused_force G)
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTpw = kG / kWarps;       // slots per warp
constexpr int kCap = 2048;              // staged particles per round
constexpr int kStage = kCap / kThreads; // staged particles per thread
constexpr int kPending = -128;          // type code of a pending source in
                                        // count mode, and of no particle
                                        // (slot types are -9 or 0..7)

struct Staged {
    float x[kCap], y[kCap], z[kCap];
    signed char code[kCap];     // type (aux & 7); kPending for aux >= 8
                                // in count mode
    int j[kCap];                // sorted id
    seg_rounds::Round<kCap> round;
    unsigned long long may[kCap / 32];  // per batch of 32 staged
                                        // particles, bit s: slot s may hit
    float tx[kG], ty[kG], tz[kG];       // the slots: position,
    float lim[kG];                      // radius test,
    int typ[kG], me[kG];                // type and sorted id
};

// Whether a target at t with radius test r^2 < lim may hit a particle in
// the box [lo, hi]: false only when the box lies beyond the radius by a
// margin (1e-4 relative) far above the rounding of r^2 and of the box's
// distance (a few float32 ULPs each), so that no particle of a batch
// judged unreachable would pass r^2 < lim.
__device__ __forceinline__ bool may_reach(const float* lo, const float* hi,
                                          float x, float y, float z,
                                          float lim) {
    const float t[3] = {x, y, z};
    float d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        d[c] = fmaxf(fmaxf(__fsub_rn(lo[c], t[c]), __fsub_rn(t[c], hi[c])),
                     0.0f);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]),
                                         __fmul_rn(d[1], d[1])),
                               __fmul_rn(d[2], d[2]));
    return !(d2 > __fadd_rn(__fmul_rn(lim, 1.0001f), 1e-30f));
}

// A float as an int of the same order (for the warp's integer min/max),
// and back.
__device__ __forceinline__ int ordered(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float unordered(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

template <bool kCount, bool kBox>
__global__ void __launch_bounds__(kThreads, 2)
sidm_emit_kernel(const int* __restrict__ order, const int* __restrict__ keys,
                 const int* __restrict__ nn, int LR,
                 const float4* __restrict__ src,
                 const float* __restrict__ gt, const float* __restrict__ gr,
                 const int* __restrict__ gty, const int* __restrict__ gidx,
                 int K, float box, int* __restrict__ cand,
                 int* __restrict__ ncand, int* __restrict__ needk) {
    __shared__ Staged S;
    const int g = order[blockIdx.x];
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const unsigned lower = (1u << lane) - 1u;

    // the slots, each read and its radius test (0 on a dead slot: no hit)
    // found once
    if (t < kG) {
        const int slot = g * kG + t;
        const int m = gidx[slot];
        const float r = gr[slot];
        S.tx[t] = gt[slot * 3 + 0];
        S.ty[t] = gt[slot * 3 + 1];
        S.tz[t] = gt[slot * 3 + 2];
        S.lim[t] = m < 0 ? 0.0f
                   : kCount ? sidm_pair::sqrt_lt_bound(r) : __fmul_rn(r, r);
        S.typ[t] = gty[slot];
        S.me[t] = m;
    }
    __syncthreads();
    // this warp's slots in registers, and their hits (count mode: this
    // lane's)
    float tx[kTpw], ty[kTpw], tz[kTpw], lim[kTpw];
    int typ[kTpw], me[kTpw], hits[kTpw];
#pragma unroll
    for (int i = 0; i < kTpw; ++i) {
        const int s = i * kWarps + warp;
        me[i] = S.me[s];
        tx[i] = S.tx[s];
        ty[i] = S.ty[s];
        tz[i] = S.tz[s];
        lim[i] = S.lim[s];
        typ[i] = S.typ[s];
        hits[i] = 0;
    }
    unsigned long long wbits = 0;       // this warp's slots' bits
#pragma unroll
    for (int i = 0; i < kTpw; ++i) wbits |= 1ull << (i * kWarps + warp);
    const int nk = min(max(nn[g], 0), LR);
    const int* kg = keys + (int64_t)g * LR;

    int key = seg_rounds::next_key(kg, 0, nk, t);
    for (int c0 = 0; c0 < nk;) {
        const int taken = seg_rounds::plan<kCap>(S.round, key, c0, nk, t);
        const int total = S.round.off[taken];
        c0 += taken;
        key = seg_rounds::next_key(kg, c0, nk, t);
        // every thread stages kStage particles, their loads in flight
        // together; the lanes of warp w hold batch i * kWarps + w of 32
        // particles, whose box gives the slots that batch may reach
        // (with a periodic box: every slot)
        int jj[kStage];
        float4 q[kStage];
#pragma unroll
        for (int i = 0; i < kStage; ++i) {
            const int p = t + i * kThreads;
            jj[i] = p < total ? seg_rounds::staged_id(S.round, p) : -1;
            q[i] = jj[i] >= 0 ? __ldg(src + jj[i])
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int i = 0; i < kStage; ++i) {
            const int p = t + i * kThreads;
            if (jj[i] >= 0) {
                const int aux = (int)q[i].w;
                S.x[p] = q[i].x;
                S.y[p] = q[i].y;
                S.z[p] = q[i].z;
                S.code[p] = (kCount && aux >= 8) ? kPending : (aux & 7);
                S.j[p] = jj[i];
            }
            const int b = i * kWarps + warp;
            if (kBox || b * 32 >= total) continue;      // uniform
            // the box of the batch's finite particles (no other can hit)
            const bool fin = jj[i] >= 0 && isfinite(q[i].x)
                             && isfinite(q[i].y) && isfinite(q[i].z);
            float lo[3], hi[3];
            const float c[3] = {q[i].x, q[i].y, q[i].z};
#pragma unroll
            for (int e = 0; e < 3; ++e) {
                lo[e] = unordered(__reduce_min_sync(
                    0xffffffffu, ordered(fin ? c[e] : INFINITY)));
                hi[e] = unordered(__reduce_max_sync(
                    0xffffffffu, ordered(fin ? c[e] : -INFINITY)));
            }
            const unsigned m0 = __ballot_sync(
                0xffffffffu, may_reach(lo, hi, S.tx[lane], S.ty[lane],
                                       S.tz[lane], S.lim[lane]));
            const unsigned m1 = __ballot_sync(
                0xffffffffu, may_reach(lo, hi, S.tx[lane + 32],
                                       S.ty[lane + 32], S.tz[lane + 32],
                                       S.lim[lane + 32]));
            if (lane == 0) S.may[b] = ((unsigned long long)m1 << 32) | m0;
        }
        __syncthreads();
        for (int k0 = 0; k0 < total; k0 += 32) {
            const unsigned long long may = kBox ? ~0ull : S.may[k0 >> 5];
            if (!(may & wbits)) continue;   // none of this warp's slots
            const int k = k0 + lane;
            float px = 0.0f, py = 0.0f, pz = 0.0f;
            int pc = kPending, pj = -1;     // a lane past the round: no hit
            if (k < total) {
                px = S.x[k];
                py = S.y[k];
                pz = S.z[k];
                pc = S.code[k];
                pj = S.j[k];
            }
#pragma unroll
            for (int i = 0; i < kTpw; ++i) {
                if (!((may >> (i * kWarps + warp)) & 1ull)) continue;
                float d0 = __fsub_rn(tx[i], px), d1 = __fsub_rn(ty[i], py),
                      d2 = __fsub_rn(tz[i], pz);
                if (kBox) {
                    d0 = sidm_pair::min_image(d0, box);
                    d1 = sidm_pair::min_image(d1, box);
                    d2 = sidm_pair::min_image(d2, box);
                }
                const float rr = __fadd_rn(
                    __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                    __fmul_rn(d2, d2));
                const bool hit = pc == typ[i] && pj != me[i] && rr < lim[i];
                if (kCount) {
                    hits[i] += hit;
                    continue;
                }
                const unsigned m = __ballot_sync(0xffffffffu, hit);
                if (hit) {
                    const int at = hits[i] + __popc(m & lower);
                    if (at < K) cand[(int64_t)me[i] * K + at] = pj;
                }
                hits[i] += __popc(m);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kTpw; ++i) {
        if (kCount) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                hits[i] += __shfl_xor_sync(0xffffffffu, hits[i], o);
        }
        if (me[i] < 0) continue;
        if (kCount) {
            if (lane == 0) ncand[me[i]] = hits[i];
            continue;
        }
        if (lane == 0) {
            ncand[me[i]] = min(hits[i], K);
            needk[me[i]] = hits[i];
        }
    }
}

template <bool kCount, bool kBox>
void launch(const int* order, const int* keys, const int* nn, int ng, int LR,
            const float* src, const float* gt, const float* gr,
            const int* gty, const int* gidx, int K, float box, int* cand,
            int* ncand, int* needk, cudaStream_t stream) {
    sidm_emit_kernel<kCount, kBox><<<ng, kThreads, 0, stream>>>(
        order, keys, nn, LR, reinterpret_cast<const float4*>(src), gt, gr,
        gty, gidx, K, box, cand, ncand, needk);
}

}  // namespace

// order (ng,) the groups in launch order; keys (ng, LR) segment keys with
// live counts nn; src (n,) float4 [x y z aux]; gt (ng, 64, 3), gr/gty/gidx
// (ng, 64); box the periodic box (0: none). Record mode: cand (n, K)
// IMAX-filled, ncand and needk (n,) zero-filled. Count mode: cand and
// needk null, the counts in ncand (zero-filled).
extern "C" int sidm_emit_launch(const int* order, const int* keys,
                                const int* nn, int ng, int LR,
                                const float* src, int n, const float* gt,
                                const float* gr, const int* gty,
                                const int* gidx, int K, int count_mode,
                                float box, int* cand, int* ncand,
                                int* needk, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    (void)n;
    if (ng > 0) {
        const bool b = box > 0.0f;
        if (count_mode && b)
            launch<true, true>(order, keys, nn, ng, LR, src, gt, gr, gty,
                               gidx, K, box, cand, ncand, needk, st);
        else if (count_mode)
            launch<true, false>(order, keys, nn, ng, LR, src, gt, gr, gty,
                                gidx, K, box, cand, ncand, needk, st);
        else if (b)
            launch<false, true>(order, keys, nn, ng, LR, src, gt, gr, gty,
                                gidx, K, box, cand, ncand, needk, st);
        else
            launch<false, false>(order, keys, nn, ng, LR, src, gt, gr, gty,
                                 gidx, K, box, cand, ncand, needk, st);
    }
    return (int)cudaGetLastError();
}
