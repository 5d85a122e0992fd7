// Row gather from a (M, 16) float32 table, with an optional sum of each
// gathered row. Port of scripts/pallas_gather_probe.py kernel_A/B/C (rows)
// and scripts/gatherbench.py gather_kernel / onehot_kernel (row sums); see
// sidm_tpu_torch/ops/gather.py for the contract and the design note.
// node_rows_kernel is the list engine's compact node table gathered
// straight from the tree's own arrays (gather_nodes).
//
// Four threads per output row, one 16-byte load each: a warp reads eight
// whole 64-byte rows, neighbouring threads on neighbouring addresses. An id
// outside [0, M) reads zeros (the list engine's dead entries point at
// id M, an appended zero row). In row-sum mode the four partial sums of a
// row are added with two warp shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float4* __restrict__ tbl, int M,
              const int* __restrict__ ids, int64_t n,
              float4* __restrict__ rows, float* __restrict__ sums) {
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t r = tid >> 2;
    const int q = (int)(tid & 3);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n) {
        const int id = ids[r];
        if (id >= 0 && id < M) v = __ldg(tbl + (int64_t)id * 4 + q);
    }
    if (sums == nullptr) {
        if (r < n) rows[r * 4 + q] = v;
        return;
    }
    // every lane of the warp reaches the shuffles (the grid is a whole
    // number of warps and no lane has returned)
    float s = (v.x + v.y) + (v.z + v.w);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q == 0 && r < n) sums[r] = s;
}

// The compact table's rows from the tree: out[r] columns 0-3 = mac_rows[id]
// columns 0-3 (com, mass), columns 8-14 = quad_rows[id] columns 0-6
// (quadrupole, eps_max); an id outside [0, M) gives zeros there. Columns
// 4-7 and 15, which no reader of the table reads, are NaN. One thread per
// row: three independent 16-byte loads from two 32-byte rows, four 16-byte
// stores.
__global__ void __launch_bounds__(kThreads)
node_rows_kernel(const float4* __restrict__ mac,
                 const float4* __restrict__ quad, int M,
                 const int* __restrict__ ids, int64_t n,
                 float* __restrict__ out) {
    const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (r >= n) return;
    const int id = ids[r];
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q0 = m, q1 = m;
    if (id >= 0 && id < M) {
        m = __ldg(mac + (int64_t)id * 2);
        q0 = __ldg(quad + (int64_t)id * 2);
        q1 = __ldg(quad + (int64_t)id * 2 + 1);
    }
    const float nan = __int_as_float(0x7fc00000);
    float4* o = reinterpret_cast<float4*>(out) + r * 4;
    o[0] = m;
    o[1] = make_float4(nan, nan, nan, nan);
    o[2] = q0;
    o[3] = make_float4(q1.x, q1.y, q1.z, nan);
}

}  // namespace

extern "C" int node_rows_launch(const float* mac, const float* quad, int M,
                                const int* ids, long long n, float* out,
                                void* stream) {
    if (n > 0)
        node_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                           kThreads, 0, (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(mac),
            reinterpret_cast<const float4*>(quad), M, ids, (int64_t)n, out);
    return (int)cudaGetLastError();
}

// rows != null: rows[i] = tbl[ids[i]]; otherwise sums[i] = sum of that row.
extern "C" int gather_launch(const float* tbl, int M, const int* ids,
                             long long n, float* rows, float* sums,
                             void* stream) {
    if (n > 0) {
        const long long blocks = (4 * n + kThreads - 1) / kThreads;
        gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(tbl), M, ids, (int64_t)n,
            reinterpret_cast<float4*>(rows), sums);
    }
    return (int)cudaGetLastError();
}
