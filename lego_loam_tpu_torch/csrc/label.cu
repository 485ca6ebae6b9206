// Connected-component labelling of the (V, H) range image on Hopper.
//
// Replaces the TPU kernel frontend/pallas_label.py::propagate_labels_pallas
// (body _kernel/_segmented_sweep) of the JAX package.  That kernel keeps the
// whole image in VMEM and iterates dense log-doubling min-scans to a fixed
// point; nothing of that shape is wanted here.  The contract is the output:
// every segmentable pixel gets the MINIMUM flat index of its component under
// the precomputed merge edges, every other pixel the sentinel 2^30.
//
// What bounds it on this card: neither bytes nor operations.  It reads
// 3 x V*H int32 and writes V*H int32 (0.46 MB at 16x1800, 2.1 MB at 64x2083),
// microseconds at the card's memory rate; the cost is the launch latency of
// three tiny dependent kernels plus the pointer chasing of the finds.  The
// design therefore keeps the launch count fixed and small (init, union,
// compress on one stream, no host synchronisation, no iteration to a fixed
// point) and works in global memory, which the 50 MB L2 serves, so any
// (V, H) runs, including the 533 KB HDL-64 image that no block's shared memory
// could hold.
//
// Algorithm: label-equivalence union-find.  parent[p] = p on segmentable
// pixels.  One thread per pixel unions p with its right neighbour (column
// j+1 mod H, so the H-1 <-> 0 wrap edge is an ordinary edge) and its lower
// neighbour where the edge flag is set.  A union always hangs the LARGER
// root under the SMALLER one with atomicMin, so a root is the minimum index
// of its tree and, once all edges are in, of its component.  The last kernel
// writes label[p] = find(p).  Union-find always converges, so the result
// equals the fixed-point flood wherever that flood converged within its
// sweep cap (max_label_iters); on an image the flood would give up on, this
// kernel still returns the true components.
//
// Plain C interface, no allocation, no synchronisation; returns
// cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 1 << 30;
constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
    // parents only ever decrease, so this walk terminates at a root
    while (true) {
        int p = *reinterpret_cast<const volatile int*>(parent + x);
        if (p == x) return x;
        x = p;
    }
}

__device__ void unite(int* parent, int a, int b) {
    while (true) {
        a = find_root(parent, a);
        b = find_root(parent, b);
        if (a == b) return;
        int hi = a > b ? a : b;
        int lo = a > b ? b : a;
        int old = atomicMin(parent + hi, lo);
        if (old == hi) return;          // hi was still a root: now under lo
        // hi had already been hung under `old` (< hi) by another thread;
        // its parent is now min(old, lo) and the other one still has to
        // be joined to that tree.
        a = old;
        b = lo;
    }
}

__global__ void init_kernel(const int* __restrict__ labels0,
                            int* __restrict__ parent, int n) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) parent[p] = labels0[p] == p ? p : kSentinel;
}

__global__ void union_kernel(const int* __restrict__ right,
                             const int* __restrict__ down,
                             int* parent, int V, int H) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    int n = V * H;
    if (p >= n) return;
    if (*reinterpret_cast<volatile int*>(parent + p) == kSentinel) return;
    int i = p / H;
    int j = p - i * H;
    if (right[p]) {
        int q = i * H + (j + 1 == H ? 0 : j + 1);
        if (q != p && *reinterpret_cast<volatile int*>(parent + q) != kSentinel)
            unite(parent, p, q);
    }
    if (i + 1 < V && down[p]) {
        int q = p + H;
        if (*reinterpret_cast<volatile int*>(parent + q) != kSentinel)
            unite(parent, p, q);
    }
}

__global__ void compress_kernel(const int* __restrict__ parent,
                                int* __restrict__ out, int n) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    out[p] = parent[p] == kSentinel ? kSentinel : find_root(parent, p);
}

}  // namespace

extern "C" int label_ccl(const void* labels0, const void* right,
                         const void* down, void* parent, void* out,
                         int V, int H, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int n = V * H;
    int blocks = (n + kThreads - 1) / kThreads;
    init_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(labels0), static_cast<int*>(parent), n);
    union_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(right), static_cast<const int*>(down),
        static_cast<int*>(parent), V, H);
    compress_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int*>(parent), static_cast<int*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
