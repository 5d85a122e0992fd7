// The DSMC pass over the range walk's segments (K4): per gated target, the
// kernel-weighted pair probabilities against the particles of its group's
// walked segments, their sum, the neighbour count and the Gumbel-max
// partner. Port of sidm_tpu/ops/fused_range.py:_sidm_near_tile (:127) as
// _sidm_near_level (:207) drives it over the walk's levels, plain XLA in
// the JAX package (no Pallas original); see
// sidm_tpu_torch/ops/fused_range.py (sidm_near) for the contract.
//
// One block per target group (kG = 64 slots), kSplit = 4 threads per slot.
// The group's segment keys start*32+cnt (cnt <= 31) are read kChunk at a
// time; their particles' rows [pos3 vel3 mass aux] are staged in shared
// memory with their sorted ids, in key order then particle order. Thread
// s*kSplit + q takes the staged particles q, q + kSplit, ... for slot s.
// Per pair: d = x_i - x_j (minimum image with a periodic box), r = |d|,
// ok = live slot, j != i, r < h, the partner of the same type and with no
// pending kick; P_j = 0.5 m_j W(r/h)/h^3 sigma(v) v dt; the key
// log(max(P_j, 1e-37)) + Gumbel(i, j, salt) for P_j > 0. The pair math is
// the gated tile's (sidm_pair.cuh), rounded one operation at a time (the
// file builds with -fmad=false), so a key equals the plain version's bit
// for bit; the kSplit partial sums, counts and (key, id) maxima are
// combined by a fixed shuffle tree, the larger sorted id winning on equal
// keys (the sum is taken in another order than the plain version's). What
// bounds it on the H100: operations, about 46 per live pair and 12 per
// other (target, segment particle) pair; each staged row is read once per
// group.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sidm_pair.cuh"

namespace {

using sidm_pair::min_image;
using sidm_pair::pair_gumbel;
using sidm_pair::Sigma;
using sidm_pair::sph_kernel;

constexpr int kG = 64;          // slots per group (ops/fused_force.py G)
constexpr int kSplit = 4;       // threads per slot
constexpr int kT = kG * kSplit;
constexpr int kChunk = 32;      // segment keys staged per round
constexpr int kMaxSeg = 31;     // particles per segment key
constexpr int kImax = 2147483647;

struct Slots {                  // per group slot, (ng, 64[, 3])
    const float* gt;            // position
    const float* gv;            // velocity
    const float* gh;            // search radius h (0: not gated)
    const float* gdt;           // dt_h0
    const int* gty;             // type (-9: dead)
    const int* gidx;            // sorted id (-1: dead)
};

__global__ void __launch_bounds__(kT)
sidm_near_kernel(const int* __restrict__ keys, const int* __restrict__ nn,
                 int L, const float4* __restrict__ rows, const Slots sl,
                 uint32_t salt, Sigma sigma, float box,
                 float* __restrict__ ptot, int* __restrict__ ncnt,
                 float* __restrict__ bestk, int* __restrict__ bestj) {
    __shared__ float4 s0[kChunk * kMaxSeg];     // x y z vx
    __shared__ float4 s1[kChunk * kMaxSeg];     // vy vz m aux
    __shared__ int sj[kChunk * kMaxSeg];
    __shared__ int seg_off[kChunk + 1];

    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int q = t % kSplit;
    const int slot = g * kG + t / kSplit;
    const int me = sl.gidx[slot];
    const float th = sl.gh[slot];
    const bool live = me >= 0 && th > 0.0f;
    const float tx = sl.gt[slot * 3 + 0], ty = sl.gt[slot * 3 + 1],
                tz = sl.gt[slot * 3 + 2];
    const float vx = sl.gv[slot * 3 + 0], vy = sl.gv[slot * 3 + 1],
                vz = sl.gv[slot * 3 + 2];
    const float tdt = sl.gdt[slot];
    const int typ = sl.gty[slot];
    const float h = fmaxf(th, 1e-30f);
    const float h3 = h * h * h;
    float psum = 0.0f, bk = -INFINITY;
    int cn = 0, bj = -1;
    // a group with no live slot walked no segment (parked box)
    const int nk = min(max(nn[g], 0), L);
    const int* kg = keys + (int64_t)g * L;

    for (int c0 = 0; c0 < nk; c0 += kChunk) {
        if (warp == 0) {
            // this round's keys: counts and their exclusive prefix sums
            int cnt = 0;
            if (c0 + lane < nk) {
                const int key = kg[c0 + lane];
                if (key != kImax) cnt = key & 31;
            }
            int inc = cnt;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, inc, o);
                if (lane >= o) inc += y;
            }
            seg_off[lane] = inc - cnt;
            if (lane == 31) seg_off[kChunk] = inc;
        }
        __syncthreads();
        const int total = seg_off[kChunk];
        // stage: warp w copies the keys w, w + 8, ... (lanes < cnt)
        const int nseg = min(kChunk, nk - c0);
        for (int s = warp; s < nseg; s += kT / 32) {
            const int ks = kg[c0 + s];
            if (ks == kImax) continue;
            const int st = ks >> 5, cs = ks & 31;
            if (lane < cs) {
                const int j = st + lane;
                s0[seg_off[s] + lane] = __ldg(rows + (int64_t)j * 2);
                s1[seg_off[s] + lane] = __ldg(rows + (int64_t)j * 2 + 1);
                sj[seg_off[s] + lane] = j;
            }
        }
        __syncthreads();
        if (live) {
            for (int k = q; k < total; k += kSplit) {
                const float4 b0 = s0[k], b1 = s1[k];
                const int j = sj[k];
                const int aux = (int)b1.w;
                if (j == me || aux >= 8 || (aux & 7) != typ) continue;
                const float d0 = min_image(tx - b0.x, box);
                const float d1 = min_image(ty - b0.y, box);
                const float d2 = min_image(tz - b0.z, box);
                const float r = sqrtf(d0 * d0 + d1 * d1 + d2 * d2);
                if (!(r < th)) continue;
                ++cn;
                const float wk = sph_kernel(r / h) / h3;
                const float w0 = vx - b0.w, w1 = vy - b1.x, w2 = vz - b1.y;
                const float rv = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
                const float prob = 0.5f * b1.z * wk * sigma(rv) * tdt;
                psum += prob;
                if (prob > 0.0f) {
                    const float key = logf(fmaxf(prob, 1e-37f))
                                      + pair_gumbel((uint32_t)me,
                                                    (uint32_t)j, salt);
                    if (key > bk || (key == bk && j > bj)) {
                        bk = key;
                        bj = j;
                    }
                }
            }
        }
        __syncthreads();
    }
    // combine the kSplit threads of a slot (adjacent lanes), fixed order
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
        cn += __shfl_xor_sync(0xffffffffu, cn, o);
        const float ok = __shfl_xor_sync(0xffffffffu, bk, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (ok > bk || (ok == bk && oj > bj)) {
            bk = ok;
            bj = oj;
        }
    }
    if (q == 0) {
        ptot[slot] = psum;
        ncnt[slot] = cn;
        bestk[slot] = bk;
        bestj[slot] = isfinite(bk) ? bj : -1;
    }
}

}  // namespace

// keys (ng, L) segment keys with live counts nn; rows (n, 8) float32
// sorted [pos3 vel3 mass aux]; gt, gv (ng, 64, 3), gh, gdt, gty, gidx
// (ng, 64); box the periodic box (0: none); outputs (ng, 64), every slot
// written (0, 0, -inf, -1 where nothing scatters).
extern "C" int sidm_near_launch(const int* keys, const int* nn, int ng,
                                int L, const float* rows, int n,
                                const float* gt, const float* gv,
                                const float* gh, const float* gdt,
                                const int* gty, const int* gidx,
                                unsigned salt, int cs_type, float sigma_co,
                                float vc, float vel_scale, float pow_law,
                                float box, float* ptot, int* ncnt,
                                float* bestk, int* bestj, void* stream) {
    (void)n;
    if (ng <= 0) return 0;
    const Sigma sigma{cs_type, sigma_co, vc, vel_scale, pow_law};
    const Slots sl{gt, gv, gh, gdt, gty, gidx};
    sidm_near_kernel<<<ng, kT, 0, (cudaStream_t)stream>>>(
        keys, nn, L, reinterpret_cast<const float4*>(rows), sl,
        (uint32_t)salt, sigma, box, ptot, ncnt, bestk, bestj);
    return (int)cudaGetLastError();
}
