// Rounds over a group's segment keys start*32+cnt (cnt <= 31; IMAX keys
// and keys past the live count cover nothing), shared by the candidate
// emission (sidm_emit.cu) and the walk's segment pass (sidm_near.cu): each
// round takes the next keys, in key order, whose particles fit the block's
// staging buffer of kCap particles. The threads t < kScan each hold one
// key of the kScan that follow the last round's (loaded during that
// round's work, so that the load's latency is hidden); a block-wide scan
// of their counts gives each key's offset in the buffer, and the round
// takes the longest prefix of them that fits (at least kCap / 31 keys),
// so a round stages close to kCap particles whatever the keys' counts.
// Each taken key also writes its index over its particles' places, so a
// staged particle finds its key with one shared-memory read.
#pragma once

#include <stdint.h>

namespace seg_rounds {

constexpr int kScan = 512;              // keys scanned per round (and
                                        // the least block size)
constexpr int kImax = 2147483647;

template <int kCap>
struct Round {
    int off[kScan + 1];                 // exclusive offsets of the keys
    int start[kScan];                   // first particle of each key
    int wtot[kScan / 32];               // per-warp sums of the scan
    unsigned short key[kCap];           // the key of each staged particle
};

// The key thread t holds for the round that starts at key c0 (IMAX past
// the nk live keys).
__device__ __forceinline__ int next_key(const int* kg, int c0, int nk,
                                        int t) {
    return (t < kScan && c0 + t < nk) ? kg[c0 + t] : kImax;
}

// Plans the round at key c0 from the keys the threads hold: writes the
// offsets, starts and particles' keys, and returns the number of keys
// taken (the same in every thread); the round's particles are
// R.off[taken]. Every thread of the block calls it (it holds two
// barriers).
template <int kCap>
__device__ __forceinline__ int plan(Round<kCap>& R, int key, int c0, int nk,
                                    int t) {
    const int lane = t & 31, warp = t >> 5;
    const bool mine = t < kScan;
    const int cnt = (mine && key != kImax) ? key & 31 : 0;
    int inc = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
    }
    if (mine && lane == 31) R.wtot[warp] = inc;
    __syncthreads();
    const bool take = mine && c0 + t < nk;
    if (mine) {
        for (int w = 0; w < warp; ++w) inc += R.wtot[w];
        R.off[t] = inc - cnt;
        R.start[t] = key >> 5;
        if (t == kScan - 1) R.off[kScan] = inc;
        if (take && inc <= kCap)
            for (int p = inc - cnt; p < inc; ++p)
                R.key[p] = (unsigned short)t;
    }
    return __syncthreads_count(take && inc <= kCap);
}

// The sorted id of staged particle p < R.off[taken].
template <int kCap>
__device__ __forceinline__ int staged_id(const Round<kCap>& R, int p) {
    const int s = R.key[p];
    return R.start[s] + p - R.off[s];
}

}  // namespace seg_rounds
