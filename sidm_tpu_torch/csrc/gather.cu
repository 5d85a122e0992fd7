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
// id M, an appended zero row).
//
// Row sums: the sum of a gathered row is the gathered row sum, so the M
// row sums are computed once per call (row_sums_kernel, one thread per
// row) and the gather reads 4 bytes per id instead of 64
// (sum_gather_kernel): each block of a persistent grid stages the M + 1
// sums (the last one 0) in shared memory when they fit (both of the TPU
// probe's tables do: 2^14 and 2^10 rows) and reads them from there,
// otherwise from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

constexpr int kSumBlocks = 264;          // persistent grid: 2 per SM
constexpr int kSumThreads = 1024;
constexpr int kSmemSums = 48 * 1024;     // staged sums at most (floats)

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float4* __restrict__ tbl, int M,
              const int* __restrict__ ids, int64_t n,
              float4* __restrict__ rows) {
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t r = tid >> 2;
    const int q = (int)(tid & 3);
    if (r >= n) return;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int id = ids[r];
    if (id >= 0 && id < M) v = __ldg(tbl + (int64_t)id * 4 + q);
    rows[r * 4 + q] = v;
}

// sums[m] = sum of row m (m < M), sums[M] = 0.
__global__ void __launch_bounds__(kThreads)
row_sums_kernel(const float4* __restrict__ tbl, int M,
                float* __restrict__ sums) {
    const int m = blockIdx.x * kThreads + threadIdx.x;
    if (m > M) return;
    float s = 0.0f;
    if (m < M) {
        const float4* p = tbl + (int64_t)m * 4;
        const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2),
                     d = __ldg(p + 3);
        s = (((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w)))
            + (((c.x + c.y) + (c.z + c.w)) + ((d.x + d.y) + (d.z + d.w)));
    }
    sums[m] = s;
}

// out[i] = sums[ids[i]] (0 for an id outside [0, M]). Each thread takes
// four ids at a time (one 16-byte load, one 16-byte store), two such
// groups in flight, over a persistent grid; vec = 0 (ids or out not
// 16-byte aligned) takes them one at a time.
__device__ __forceinline__ float lookup(const float* s, int M, int id) {
    return (id >= 0 && id <= M) ? s[id] : 0.0f;
}

__global__ void __launch_bounds__(kSumThreads)
sum_gather_kernel(const float* __restrict__ sums, int M, int staged,
                  const int* __restrict__ ids, int64_t n, int vec,
                  float* __restrict__ out) {
    extern __shared__ float ss[];
    if (staged)
        for (int m = threadIdx.x; m <= M; m += kSumThreads) ss[m] = sums[m];
    __syncthreads();
    const float* s = staged ? ss : sums;
    const int64_t stride = (int64_t)gridDim.x * kSumThreads;
    const int64_t t0 = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
    int64_t done = 0;
    if (vec) {
        const int64_t n4 = n / 4;
        const int4* ids4 = reinterpret_cast<const int4*>(ids);
        float4* out4 = reinterpret_cast<float4*>(out);
        int64_t v = t0;
        for (; v + stride < n4; v += 2 * stride) {
            const int4 a = __ldg(ids4 + v), b = __ldg(ids4 + v + stride);
            out4[v] = make_float4(lookup(s, M, a.x), lookup(s, M, a.y),
                                  lookup(s, M, a.z), lookup(s, M, a.w));
            out4[v + stride] = make_float4(
                lookup(s, M, b.x), lookup(s, M, b.y), lookup(s, M, b.z),
                lookup(s, M, b.w));
        }
        if (v < n4) {
            const int4 a = __ldg(ids4 + v);
            out4[v] = make_float4(lookup(s, M, a.x), lookup(s, M, a.y),
                                  lookup(s, M, a.z), lookup(s, M, a.w));
        }
        done = 4 * n4;
    }
    for (int64_t i = done + t0; i < n; i += stride)
        out[i] = lookup(s, M, __ldg(ids + i));
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

// rows[i] = tbl[ids[i]].
extern "C" int gather_launch(const float* tbl, int M, const int* ids,
                             long long n, float* rows, void* stream) {
    if (n > 0) {
        const long long blocks = (4 * n + kThreads - 1) / kThreads;
        gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(tbl), M, ids, (int64_t)n,
            reinterpret_cast<float4*>(rows));
    }
    return (int)cudaGetLastError();
}

// out[i] = sum of row ids[i] of tbl; sums (M + 1,) is the caller's scratch.
extern "C" int rowsum_launch(const float* tbl, int M, const int* ids,
                             long long n, float* sums, float* out,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    row_sums_kernel<<<(M + kThreads) / kThreads, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(tbl), M, sums);
    if (n > 0) {
        const int staged = M + 1 <= kSmemSums;
        const size_t smem = staged ? (size_t)(M + 1) * sizeof(float) : 0;
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(sum_gather_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        const int vec = ((uintptr_t)ids % 16 == 0)
                        && ((uintptr_t)out % 16 == 0);
        const long long need = (n + 4LL * kSumThreads - 1)
                               / (4LL * kSumThreads);
        const int blocks = (int)(need < kSumBlocks ? need : kSumBlocks);
        sum_gather_kernel<<<blocks, kSumThreads, smem, st>>>(
            sums, M, staged, ids, (int64_t)n, vec, out);
    }
    return (int)cudaGetLastError();
}
