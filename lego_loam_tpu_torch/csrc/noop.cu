// An empty kernel, launched through the same ctypes route as the real ones.
//
// It exists for measurement only: timing it shows what one kernel launch
// costs on a given card and host (device-side launch overhead when many are
// queued or replayed from a CUDA graph, host-side enqueue cost when called
// one at a time), which is the floor under the time of any kernel here.

#include <cuda_runtime.h>

namespace {
__global__ void noop_kernel() {}
}  // namespace

extern "C" int noop_launch(void* stream) {
    noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
