// The gated DSMC tile: per gated target over its cached candidates, the
// kernel-weighted pair probabilities, their sum, the neighbour count and
// the Gumbel-max partner. Port of the tile of
// sidm_tpu/ops/list_range.py:_eval_gated (:434-484), plain XLA in the JAX
// package (no Pallas original); see sidm_tpu_torch/ops/list_range.py for
// the contract.
//
// Per pair: r = |x_i - x_j|, ok = r < h and the partner has no pending
// kick; P_j = 0.5 m_j W(r/h)/h^3 sigma(v) v dt; the key
// log(max(P_j, 1e-37)) + Gumbel(i, j, salt) for P_j > 0. The pair
// arithmetic is the plain version's, rounded one operation at a time (the
// file builds with -fmad=false), so the keys match it bit for bit; the
// sum is taken in another order (float32 rounding). With a periodic box
// (box > 0) each difference is taken by the minimum image. The pair math
// lives in sidm_pair.cuh, shared with the walk's segment pass.
//
// Design (what bounds it on the H100: bytes, the candidate ids and the
// candidates' 32-byte rows gathered, and the (n,) outputs written). Two
// launches: sidm_gated_fill writes the (0, 0, -inf, -1) of every row
// (16-byte stores), then the tile writes its targets' rows. The target
// list holds the tiers' capacities (about 0.38 n slots at flagship-dsmc),
// of which a tenth are live, each a prefix of its tier: so the tile runs
// one wave of blocks, block b taking the slots b, b + G, ..., which gives
// every block an even share of the live targets; it reads its slots in
// rounds of 1024, compacts the live ones in shared memory and hands them
// to its 16 sub-groups of kLanes = 16 lanes (the flagship's targets hold
// a few tens of candidates, at most K). A lane reads the ids of up to
// kU = 4 of its candidates (c, c + 16, ...; the first round's beside the
// target's own fields, before ncand arrives), then their rows, and only
// then does their pair math. The 16 lanes' sums, counts and (key, id)
// maxima are combined by a fixed shuffle tree, the larger sorted id
// winning on equal keys as JAX's max over where(key == max, j, -1) does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resident.cuh"
#include "sidm_pair.cuh"

namespace {

using sidm_pair::min_image;
using sidm_pair::pair_key;
using sidm_pair::pair_prob;
using sidm_pair::Sigma;

constexpr int kLanes = 16;          // lanes per target
constexpr int kU = 4;               // candidates a lane loads before its math
constexpr int kT = 256;             // threads per block
constexpr int kSlots = 4;           // target slots a thread reads a round
constexpr int kFillT = 256;
constexpr int kImax = 2147483647;

// (0, 0, -inf, -1) in every row: 4 rows a thread, by 16-byte stores
__global__ void __launch_bounds__(kFillT)
sidm_gated_fill(int n, float* __restrict__ ptot, int* __restrict__ cnt,
                float* __restrict__ bestk, int* __restrict__ bestj) {
    const int i4 = blockIdx.x * kFillT + threadIdx.x;
    const int i = 4 * i4;
    if (i + 3 < n) {
        reinterpret_cast<float4*>(ptot)[i4] = make_float4(0.f, 0.f, 0.f, 0.f);
        reinterpret_cast<int4*>(cnt)[i4] = make_int4(0, 0, 0, 0);
        reinterpret_cast<float4*>(bestk)[i4] =
            make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        reinterpret_cast<int4*>(bestj)[i4] = make_int4(-1, -1, -1, -1);
    } else {
        for (int k = i; k < n; ++k) {
            ptot[k] = 0.0f;
            cnt[k] = 0;
            bestk[k] = -INFINITY;
            bestj[k] = -1;
        }
    }
}

// One target's pair loop on the kLanes lanes of its sub-group (mask m):
// the candidate ids of the first round are read before ncand is known (up
// to K, masked after), and each round's rows before their pair math.
__device__ __forceinline__ void gated_target(
        const float4* __restrict__ rows, const int* __restrict__ cand, int n,
        int K, const int* __restrict__ ncand, const float* __restrict__ hs,
        const float* __restrict__ dts, int i, int sub, unsigned m,
        uint32_t salt, const Sigma& sigma, float box,
        float* __restrict__ ptot, int* __restrict__ cnt,
        float* __restrict__ bestk, int* __restrict__ bestj) {
    const int* ci = cand + (int64_t)i * K;
    int cj[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
        const int c = u * kLanes + sub;
        cj[u] = c < K ? __ldg(ci + c) : kImax;
    }
    const int nc = min(__ldg(ncand + i), K);
    const float th = __ldg(hs + i), tdt = __ldg(dts + i);
    const float4 a0 = __ldg(rows + (int64_t)i * 2);
    const float4 a1 = __ldg(rows + (int64_t)i * 2 + 1);
    const float h = fmaxf(th, 1e-30f);
    const float h3 = h * h * h;
    float psum = 0.0f, bk = -INFINITY;
    int cn = 0, bj = -1;
    for (int c0 = 0; c0 < nc; c0 += kLanes * kU) {
        if (c0 > 0) {
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int c = c0 + u * kLanes + sub;
                cj[u] = c < nc ? __ldg(ci + c) : kImax;
            }
        }
        float4 b0[kU], b1[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            if (c0 + u * kLanes + sub >= nc) cj[u] = kImax;
            const int j = min(max(cj[u], 0), n - 1);
            if (cj[u] != kImax) {
                b0[u] = __ldg(rows + (int64_t)j * 2);
                b1[u] = __ldg(rows + (int64_t)j * 2 + 1);
            } else {
                b0[u] = b1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            if (cj[u] == kImax) continue;
            const int j = min(max(cj[u], 0), n - 1);
            const float d0 = min_image(a0.x - b0[u].x, box);
            const float d1 = min_image(a0.y - b0[u].y, box);
            const float d2 = min_image(a0.z - b0[u].z, box);
            const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
            if (!(r < th) || b1[u].w >= 8.0f) continue;
            ++cn;
            const float prob = pair_prob(r, h, h3, a0.w - b0[u].w,
                                         a1.x - b1[u].x, a1.y - b1[u].y,
                                         b1[u].z, tdt, sigma);
            psum += prob;
            if (prob > 0.0f) {
                const float key = pair_key(prob, (uint32_t)i, (uint32_t)j,
                                           salt);
                if (key > bk || (key == bk && j > bj)) {
                    bk = key;
                    bj = j;
                }
            }
        }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
        psum += __shfl_xor_sync(m, psum, o);
        cn += __shfl_xor_sync(m, cn, o);
        const float ok = __shfl_xor_sync(m, bk, o);
        const int oj = __shfl_xor_sync(m, bj, o);
        if (ok > bk || (ok == bk && oj > bj)) {
            bk = ok;
            bj = oj;
        }
    }
    if (sub == 0) {
        ptot[i] = psum;
        cnt[i] = cn;
        bestk[i] = bk;
        bestj[i] = isfinite(bk) ? bj : -1;
    }
}

// A block takes the target slots b, b + G, b + 2G, ... (G blocks, one
// wave), so that every block holds an even share of the live targets
// (tid's live slots are a prefix of each tier); a round reads up to
// kSlots * kT of its slots, compacts the live ones in shared memory and
// hands them to its sub-groups of kLanes lanes.
__global__ void __launch_bounds__(kT)
sidm_gated_kernel(const float4* __restrict__ rows, const int* __restrict__ cand,
                  int n, int K, const int* __restrict__ ncand,
                  const float* __restrict__ hs, const float* __restrict__ dts,
                  const int* __restrict__ tid, int T, uint32_t salt,
                  Sigma sigma, float box, float* __restrict__ ptot,
                  int* __restrict__ cnt, float* __restrict__ bestk,
                  int* __restrict__ bestj) {
    constexpr int kRound = kSlots * kT;
    __shared__ int live[kRound];
    __shared__ int wsum[kT / 32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int sub = t & (kLanes - 1), grp = t / kLanes;
    const unsigned m = ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));
    const int64_t G = gridDim.x;
    const int per = (int)((T - blockIdx.x + G - 1) / G);   // this block's
    for (int k0 = 0; k0 < per; k0 += kRound) {
        int ids[kSlots], c = 0;
#pragma unroll
        for (int q = 0; q < kSlots; ++q) {
            const int k = k0 + q * kT + t;
            ids[q] = k < per ? __ldg(tid + blockIdx.x + k * G) : -1;
            c += ids[q] >= 0;
        }
        int x = c;                          // block exclusive scan of c
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) wsum[warp] = x;
        __syncthreads();
        int pre = 0, tot = 0;
#pragma unroll
        for (int w = 0; w < kT / 32; ++w) {
            pre += w < warp ? wsum[w] : 0;
            tot += wsum[w];
        }
        int at = pre + x - c;
#pragma unroll
        for (int q = 0; q < kSlots; ++q)
            if (ids[q] >= 0) live[at++] = ids[q];
        __syncthreads();
        for (int e = grp; e < tot; e += kT / kLanes)
            gated_target(rows, cand, n, K, ncand, hs, dts, live[e], sub, m,
                         salt, sigma, box, ptot, cnt, bestk, bestj);
        __syncthreads();
    }
}

}  // namespace

// rows (n, 8) float32 sorted [pos3 vel3 mass aux]; cand (n, K) with live
// counts ncand; hs, dts (n,); tid (T,) target ids, -1 = unused; box the
// periodic box (0: none); outputs (n,), written whole: (0, 0, -inf, -1)
// past the targets. Two launches (the fill, the tile).
extern "C" int sidm_gated_launch(const float* rows, const int* cand, int n,
                                 int K, const int* ncand, const float* hs,
                                 const float* dts, const int* tid, int T,
                                 unsigned salt, int cs_type, float sigma_co,
                                 float vc, float vel_scale, float pow_law,
                                 float box, float* ptot, int* cnt,
                                 float* bestk, int* bestj, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    const int n4 = (n + 3) / 4;
    sidm_gated_fill<<<(n4 + kFillT - 1) / kFillT, kFillT, 0, st>>>(
        n, ptot, cnt, bestk, bestj);
    if (T > 0) {
        // one wave: the blocks the card holds at once, at most one a
        // sub-group's worth of slots
        static int cache[resident::kMaxDevices] = {};
        int held = 0;
        const cudaError_t e = resident::blocks(sidm_gated_kernel, kT, cache,
                                               &held);
        if (e != cudaSuccess) return (int)e;
        const int blocks = (int)min((int64_t)held,
                                    ((int64_t)T + kT / kLanes - 1)
                                        / (kT / kLanes));
        const Sigma sigma{cs_type, sigma_co, vc, vel_scale, pow_law};
        sidm_gated_kernel<<<blocks, kT, 0, st>>>(
            reinterpret_cast<const float4*>(rows), cand, n, K, ncand, hs, dts,
            tid, T, (uint32_t)salt, sigma, box, ptot, cnt, bestk, bestj);
    }
    return (int)cudaGetLastError();
}
