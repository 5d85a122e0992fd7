// Work items of about equal size for the near, list-far and DSMC segment
// kernels, the layout of their integer workspace, the per-group count of
// covered particles, and the fixed-order second pass that folds their
// partial results per group (sidm_tpu_torch/ops/work_items.py is the plain
// version of the split and sizes the workspace).
//
// A group of weight w (covered particles, list entries, or (live slot,
// staged particle) pairs) is cut into ceil(w / P) items of ceil(w /
// items) each, with one P for the call:
// P = max(p_min, ceil(sum w / (icap - ng))), so that at most icap items
// exist (sum ceil(w/P) <= sum w / P + ng) whatever the lists hold. Items
// are numbered group by group; every item writes its own (64, 4) slot of
// the partial buffer and items_fold combines a group's slots in item
// order, so the result does not depend on which block ran which item and
// there are no float atomics. The main kernels run one block per item: a
// grid of icap blocks, of which those past off[ng] return at once, so the
// hardware block scheduler balances the items over the SMs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace items {

constexpr int kPlanThreads = 1024;
constexpr int kImax = 2147483647;    // a segment key that covers nothing
constexpr int kPlanChunk = 8192;     // groups per shared-memory chunk

// Exclusive scan of v over the block; *total gets the block's sum. sh
// holds one int per warp. Contains __syncthreads (call from every thread).
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh,
                                                    int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        const int s = sh[w];
        before += (w < warp) ? s : 0;
        sum += s;
    }
    __syncthreads();
    *total = sum;
    return before + incl - v;
}

// The particles one group's live segment keys start*32+cnt cover (cnt <=
// 31; IMAX keys and keys past the live count nseg cover none), for a
// whole warp: the lanes read the keys side by side, and every lane gets
// the sum.
__device__ __forceinline__ int warp_cover(const int* __restrict__ kg,
                                          int nseg, int lane) {
    int s = 0;
    for (int k = lane; k < nseg; k += 32) {
        const int key = kg[k];
        s += (key != kImax) ? (key & 31) : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// Covered particles of every group (keys (ng, K) with live counts n_seg),
// one warp per group: the near kernel's weights and the emission's launch
// order (ops/fused_range.py segment_totals).
__global__ void __launch_bounds__(256)
cover_count(const int* __restrict__ keys, const int* __restrict__ n_seg,
            int ng, int K, int* __restrict__ cov) {
    const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (g >= ng) return;
    const int s = warp_cover(keys + (int64_t)g * K,
                             min(max(n_seg[g], 0), K), lane);
    if (lane == 0) cov[g] = s;
}

// Integer workspace (int32): unit[ng] | off[ng+1] | item_g[icap], and for
// the near kernel cov[ng] | k0[icap] | k1[icap] after them
// (ops/work_items.py ws_size and ws_fields read the same layout).
struct Ws {
    int *unit, *off, *item_g;
    int *cov, *k0, *k1;              // the near kernel's (null for far)
};
inline Ws ws_of(int* ws, int ng, int icap, bool near) {
    Ws w;
    w.unit = ws;
    w.off = w.unit + ng;
    w.item_g = w.off + ng + 1;
    w.cov = near ? w.item_g + icap : nullptr;
    w.k0 = near ? w.cov + ng : nullptr;
    w.k1 = near ? w.k0 + icap : nullptr;
    return w;
}

// One block of kPlanThreads threads. w (ng,) weights, each clamped to
// [0, wcap]. Writes unit[g] (the item size of group g, 0 without items),
// off[0..ng] (first item of each group; off[ng] = number of items) and
// item_g[off[g] .. off[g+1]) = g. Groups are taken kPlanChunk at a
// time: their item counts are computed with coalesced loads into shared
// memory, then each thread scans a run of consecutive groups there, so a
// chunk needs one block-wide scan.
__global__ void __launch_bounds__(kPlanThreads)
items_plan(const int* __restrict__ w, int wcap, int ng, int icap, int p_min,
           int* __restrict__ unit, int* __restrict__ off,
           int* __restrict__ item_g) {
    __shared__ long long red[kPlanThreads / 32];
    __shared__ int sh[kPlanThreads / 32];
    __shared__ int n_sh[kPlanChunk];
    const int tid = threadIdx.x;
    long long s = 0;
    for (int g = tid; g < ng; g += kPlanThreads)
        s += min(max(w[g], 0), wcap);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((tid & 31) == 0) red[tid >> 5] = s;
    __syncthreads();
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kPlanThreads / 32; ++k) sum += red[k];
    const long long room = icap - ng;   // >= 1: the wrapper's icap > ng
    const int P = (int)max((long long)p_min, (sum + room - 1) / room);

    int carry = 0;
    for (int c0 = 0; c0 < ng; c0 += kPlanChunk) {
        const int cn = min(kPlanChunk, ng - c0);
        for (int i = tid; i < cn; i += kPlanThreads) {
            const int wg = min(max(w[c0 + i], 0), wcap);
            const int n_it = (wg + P - 1) / P;
            n_sh[i] = n_it;
            unit[c0 + i] = n_it ? (wg + n_it - 1) / n_it : 0;
        }
        __syncthreads();
        const int per = (cn + kPlanThreads - 1) / kPlanThreads;
        const int r0 = min(tid * per, cn), r1 = min(r0 + per, cn);
        int mine = 0;
        for (int i = r0; i < r1; ++i) mine += n_sh[i];
        int total;
        int o = carry + block_exclusive_scan<kPlanThreads>(mine, sh, &total);
        for (int i = r0; i < r1; ++i) {
            off[c0 + i] = o;
            for (int j = 0; j < n_sh[i]; ++j) item_g[o + j] = c0 + i;
            o += n_sh[i];
        }
        carry += total;
        __syncthreads();             // n_sh is refilled next
    }
    if (tid == 0) off[ng] = carry;
}

// The second pass, one block per group: thread c calls fold(g, c, a, b)
// with the group's items a .. b-1 (a == b for a group without items),
// which combines column c of their slots in item order and writes the
// group's result, so that every group is written.
template <class Fold>
__global__ void __launch_bounds__(256)
items_fold(const int* __restrict__ off, const Fold fold) {
    const int g = blockIdx.x;
    fold(g, (int)threadIdx.x, off[g], off[g + 1]);
}

// items_fold's sum, on blocks of 256 threads: out[g] = the sum of the
// group's (64, 4) item slots in item order (0 for a group without items).
struct ItemsSum {
    const float* __restrict__ part;
    float* __restrict__ out;
    __device__ __forceinline__ void operator()(int g, int c, int a,
                                               int b) const {
        float s = 0.0f;
        for (int i = a; i < b; ++i) s += part[(int64_t)i * 256 + c];
        out[(int64_t)g * 256 + c] = s;
    }
};

// Thread (slice, t) of a block of S x 64 threads holds the sums of one
// slice for target t: add the slices in a fixed order (0, 1, ..., S-1)
// and write [ax ay az pot] as target t's row of item it's (64, 4) partial.
// red: shared [S-1][64][4]. All threads call it.
template <int S, bool POT>
__device__ __forceinline__ void store_item(float (*red)[64][4], float* part,
                                           int it, float ax, float ay,
                                           float az, float pot) {
    const int t = threadIdx.x & 63, slice = threadIdx.x >> 6;
    if (slice > 0) {
        float* r = red[slice - 1][t];
        r[0] = ax; r[1] = ay; r[2] = az; r[3] = pot;
    }
    __syncthreads();
    if (slice == 0) {
#pragma unroll
        for (int s = 0; s < S - 1; ++s) {
            ax += red[s][t][0];
            ay += red[s][t][1];
            az += red[s][t][2];
            pot += red[s][t][3];
        }
        reinterpret_cast<float4*>(part)[(int64_t)it * 64 + t] =
            make_float4(ax, ay, az, POT ? pot : 0.0f);
    }
}

}  // namespace items
