// Far field of recorded (node, target-group) pairs: the far pass of the
// cached interaction lists (sidm_tpu/ops/list_force.py _eval :604-654,
// gather form), and the port of scripts/pallasfar.py:far_kernel (see
// sidm_tpu_torch/ops/far_list.py for the contract and the design note).
//
// One thread block (128 threads) per target group walks the group's far
// list in chunks of 128 entries:
//   1. thread k gathers the node row of entry c0+k from the compact table
//      (four 16-byte loads; the table is small enough to stay in L2) and
//      keeps it if its mass is non-zero (dead entries point at a zero row);
//   2. the kept rows are compacted into shared memory, group-centred;
//   3. thread (t, half) accumulates every other staged node on target t in
//      registers and folds the sums into [ax ay az pot] once per chunk.
// The two halves are added at the end; every group's row is written, so
// there are no atomics and no uninitialised output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "far_pair.cuh"

namespace {

constexpr int kG = 64;       // targets per group
constexpr int kChunk = 128;  // list entries per chunk == threads per block
constexpr int kRow = 16;     // packed node row width (pack_tree)

__global__ void __launch_bounds__(kChunk)
far_list_kernel(const float* __restrict__ tbl, int nrows,
                const int* __restrict__ ids, const int* __restrict__ nf,
                int LF, const float* __restrict__ xc,
                const float* __restrict__ te, const float* __restrict__ gc,
                int need_pot, float* __restrict__ acc) {
    __shared__ float stage[kChunk][kStage];
    __shared__ int warp_cnt[kChunk / 32];
    __shared__ float red[kG][4];

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int n = min(nf[g], LF);
    const float gc0 = gc[g * 3 + 0], gc1 = gc[g * 3 + 1], gc2 = gc[g * 3 + 2];
    const int t = tid & (kG - 1);
    const int half = tid / kG;
    const float x0 = xc[(g * kG + t) * 3 + 0];
    const float x1 = xc[(g * kG + t) * 3 + 1];
    const float x2 = xc[(g * kG + t) * 3 + 2];
    const float nx2 = x0 * x0 + x1 * x1 + x2 * x2;
    const float tet = te[g * kG + t];
    float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // [ax ay az pot] of this half

    for (int c0 = 0; c0 < n; c0 += kChunk) {
        const int col = c0 + tid;
        float row[kRow];
        bool keep = false;
        if (col < n) {
            const int id = ids[(int64_t)g * LF + col];
            if (id >= 0 && id < nrows) {
                const float4* src =
                    reinterpret_cast<const float4*>(tbl) + (int64_t)id * 4;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float4 v = __ldg(src + k);
                    row[4 * k + 0] = v.x;
                    row[4 * k + 1] = v.y;
                    row[4 * k + 2] = v.z;
                    row[4 * k + 3] = v.w;
                }
                keep = row[3] != 0.0f;
            }
        }
        const unsigned ball = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) warp_cnt[warp] = __popc(ball);
        __syncthreads();
        int off = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kChunk / 32; ++w) {
            off += (w < warp) ? warp_cnt[w] : 0;
            total += warp_cnt[w];
        }
        if (keep)
            far_stage(stage[off + __popc(ball & ((1u << lane) - 1u))], row,
                      gc0, gc1, gc2);
        __syncthreads();
        if (total > 0) {
            FarAcc a = {};
            for (int k = half; k < total; k += 2)
                far_pair(a, stage[k], x0, x1, x2, nx2, tet, need_pot);
            far_combine(out, a, x0, x1, x2);
        }
        __syncthreads();
    }

    if (half == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) red[t][k] = out[k];
    }
    __syncthreads();
    if (half == 0) {
        float* dst = acc + ((int64_t)g * kG + t) * 4;
#pragma unroll
        for (int k = 0; k < 3; ++k) dst[k] = out[k] + red[t][k];
        dst[3] = need_pot ? out[3] + red[t][3] : 0.0f;
    }
}

}  // namespace

extern "C" int far_list_launch(const float* tbl, int nrows, const int* ids,
                               const int* nf, int ng, int LF,
                               const float* xc, const float* te,
                               const float* gc, int need_pot, float* acc,
                               void* stream) {
    if (ng > 0) {
        far_list_kernel<<<ng, kChunk, 0, (cudaStream_t)stream>>>(
            tbl, nrows, ids, nf, LF, xc, te, gc, need_pot, acc);
    }
    return (int)cudaGetLastError();
}
