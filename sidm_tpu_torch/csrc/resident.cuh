// The blocks of a kernel that the current card holds at once (its SMs times
// the blocks of `threads` threads, no dynamic shared memory, an SM holds),
// for the launchers that size one wave of blocks (range_walk.cu,
// sidm_gated.cu). Each launcher keeps its own cache, one entry a device,
// so the query runs once a kernel and card.
#pragma once

#include <cuda_runtime.h>

namespace resident {

constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t blocks(Kernel kernel, int threads,
                          int (&cache)[kMaxDevices], int* out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices && cache[dev] > 0) {
        *out = cache[dev];
        return cudaSuccess;
    }
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                          threads, 0);
    if (e != cudaSuccess) return e;
    *out = sms * per > 1 ? sms * per : 1;
    if (dev < kMaxDevices) cache[dev] = *out;
    return cudaSuccess;
}

}  // namespace resident
