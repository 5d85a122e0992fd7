// The hash grid's per-query geometry, shared by the k-th-neighbour radius
// (hash_knn.cu) and the hash DSMC scan (hash_scan.cu): the level of a
// radius, the cell of a position, the (cell, type) hash of
// sidm_tpu/ops/neighbors.py (_mix, _cell_hash, _cell_coords :75-99) and a
// warp's view of its 27 stencil buckets, deduplicated in stencil order as
// gather_candidates does (:174-188). Both including files build with
// -fmad=false, so that every product and sum rounds as in the plain
// PyTorch version (sidm_tpu_torch/ops/neighbors.py) and the cells, keys and
// levels are its own bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

namespace hash_grid {

constexpr int kCells = 27;
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
    const float4* rows;     // (LN, 2) float4: [x y z vx] [vy vz m aux]
    const int* bstart;      // (L H,)
    const int* bcount;      // (L H,)
    float ox, oy, oz, s0;   // origin and base cell size
    int L, H;
    float box;              // periodic box, 0 = none
};

__device__ __forceinline__ uint32_t mix(uint32_t h) {
    h ^= h >> 16;
    h *= 0x7FEB352Du;
    h ^= h >> 15;
    h *= 0x846CA68Bu;
    return h ^ (h >> 16);
}

__device__ __forceinline__ int cell_hash(int ix, int iy, int iz, int type,
                                         int H) {
    const uint32_t h = ((uint32_t)ix * 0x9E3779B1u)
                       ^ ((uint32_t)iy * 0x85EBCA77u)
                       ^ ((uint32_t)iz * 0xC2B2AE3Du)
                       ^ (((uint32_t)type + 1u) * 0x27D4EB2Fu);
    return (int)(mix(h) % (uint32_t)H);
}

__device__ __forceinline__ float pow2(int l) {
    return __int_as_float((127 + l) << 23);
}

// The smallest l with s0 2^l >= h, at most L - 1; *clip when s0 2^(L-1)
// < h (the stencil no longer covers the ball).
__device__ __forceinline__ int level_of(float h, const Grid& g, bool* clip) {
    int lev = 0;
    for (int l = 0; l < g.L - 1; ++l) lev += (g.s0 * pow2(l) < h) ? 1 : 0;
    *clip = g.s0 * pow2(g.L - 1) < h;
    return lev;
}

__device__ __forceinline__ float wrap(float x, float box) {
    return box > 0.0f ? x - box * floorf(x / box) : x;
}

__device__ __forceinline__ int cell_of(float x, float o, float s, float box,
                                       int* dims) {
    if (box > 0.0f) {
        const float fd = fmaxf(floorf(box / s), 1.0f);
        *dims = (int)fd;
        const int c = (int)floorf((x - o) / (box / fd));
        return ((c % *dims) + *dims) % *dims;
    }
    *dims = 0;
    return (int)floorf((x - o) / s);
}

// d - box*round(d/box) for box > 0 (rintf: half to even, as torch.round).
__device__ __forceinline__ float min_image(float d, float box) {
    return box > 0.0f ? d - box * rintf(d / box) : d;
}

// One query's stencil on a warp: the level of radius h, then for lane
// j < 27 the bucket key of stencil cell j (dx, dy, dz) = (j/9, j/3 % 3,
// j % 3) - 1, deduplicated against the earlier cells. Returns the lane's
// deduplicated bucket count (0 past 27 and for a duplicate) and start;
// *key0 the first cell's key (never a duplicate), *clip as level_of.
__device__ __forceinline__ void stencil(const Grid& g, float px, float py,
                                        float pz, int type, float h, int lane,
                                        int* count, int* start, int* key0,
                                        bool* clip) {
    const int lev = level_of(h, g, clip);
    const float s = g.s0 * pow2(lev);
    int dx, dy, dz;
    const int bx = cell_of(wrap(px, g.box), g.ox, s, g.box, &dx);
    const int by = cell_of(wrap(py, g.box), g.oy, s, g.box, &dy);
    const int bz = cell_of(wrap(pz, g.box), g.oz, s, g.box, &dz);
    const int j = lane < kCells ? lane : 0;
    int cx = bx + j / 9 - 1, cy = by + (j / 3) % 3 - 1, cz = bz + j % 3 - 1;
    if (g.box > 0.0f) {
        cx = ((cx % dx) + dx) % dx;
        cy = ((cy % dy) + dy) % dy;
        cz = ((cz % dz) + dz) % dz;
    }
    const int key = lev * g.H + cell_hash(cx, cy, cz, type, g.H);
    bool dup = lane >= kCells;
    for (int i = 0; i < kCells - 1; ++i) {
        const int ki = __shfl_sync(kFull, key, i);
        dup |= (i < lane) && ki == key;
    }
    *key0 = __shfl_sync(kFull, key, 0);
    *start = lane < kCells ? __ldg(g.bstart + key) : 0;
    *count = dup ? 0 : __ldg(g.bcount + key);
}

// The cell (index into pre/start) that holds flattened slot t: the largest
// j with pre[j] <= t (pre[27] = total > t).
__device__ __forceinline__ int cell_at(const int* pre, int t) {
    int lo = 0, hi = kCells - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= t) lo = mid; else hi = mid - 1;
    }
    return lo;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = max(x, __shfl_xor_sync(kFull, x, o));
    return x;
}

// Exclusive prefix over the lanes of c (capped counts) into pre[0..27]
// of the warp's shared row; returns the total.
__device__ __forceinline__ int stage_prefix(int c, int lane, int start,
                                            int* pre, int* st) {
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
    }
    const int total = __shfl_sync(kFull, x, 31);
    if (lane < kCells) {
        pre[lane] = x - c;
        st[lane] = start;
    }
    if (lane == kCells) pre[kCells] = total;
    __syncwarp();
    return total;
}

}  // namespace hash_grid
