// Exact 5 nearest valid candidates per query, without the (Q, M) matrix.
//
// Replaces the TPU kernel match/pallas_knn.py::knn5_pallas (body _kernel,
// post-step _exact_d2, dispatcher knn5) of the JAX package.  Contract, that
// of bruteforce.knn_chunked(k=5): idx (Q,5) int32 and d2 (Q,5) float32
// ascending; fewer than five valid candidates leave d2 = 3e38 / idx = 0 in
// the remaining slots; an invalid query gets d2 = 3e38 in all five, while
// its idx stay the neighbours of its coordinates (as in the plain version:
// callers gather by idx before they look at the mask, and five copies of
// one point would make a degenerate neighbourhood).
//
// What bounds it on this card: operations.  Q*M difference-first distance
// evaluations (268 M at 8192 x 32768, about 8 flops each) run on the FP32
// pipes, not the tensor cores: the norm-expansion form that a matrix unit
// could take cancels catastrophically far from the origin, and the callers
// gate on absolute distances.  Traffic is about 0.5 MB (queries, candidates,
// masks, 5 results per query), nothing beside that.
//
// What the design does about it: one thread per query keeps its sorted
// top-5 (d2, id) in registers; a block of 128 queries stages candidate tiles
// of 1024 through shared memory as float4, so the inner loop is one
// broadcast shared load, three subtractions and three multiply-adds per pair
// and almost never takes the insertion branch.  128 queries per block alone
// would leave most of the 132 SMs idle at these Q (64 blocks at Q = 8192,
// 16 at Q = 2048), so the candidate range is cut into `splits` slices along
// gridDim.y, each block writes a partial top-5, and a second small kernel
// merges the slices.  The 16-lane group minima, the 2 mm key quantisation,
// the far-coordinate sentinel and the M <= 32768 / M % 2048 limits of the TPU
// version are artefacts of that machine and are not reproduced: the result
// is exact, with ties resolved to the lower candidate id (candidates are
// visited in ascending id order and an equal distance never displaces an
// earlier entry).
//
// Plain C interface, no allocation, no synchronisation; returns
// cudaGetLastError() for the wrapper to check.

#include <cuda_runtime.h>

namespace {

constexpr int kQueriesPerBlock = 128;
constexpr int kTile = 1024;
constexpr float kFar = 3e38f;

struct Top5 {
    float d[5];
    int i[5];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int k = 0; k < 5; ++k) { d[k] = kFar; i[k] = 0; }
    }

    __device__ __forceinline__ void insert(float dist, int id) {
        if (dist < d[4]) {
            d[4] = dist;
            i[4] = id;
#pragma unroll
            for (int k = 4; k > 0; --k) {
                if (d[k] < d[k - 1]) {
                    float td = d[k]; d[k] = d[k - 1]; d[k - 1] = td;
                    int ti = i[k]; i[k] = i[k - 1]; i[k - 1] = ti;
                }
            }
        }
    }
};

// grid = (ceil(Q / 128), splits).  Writes (Q, splits, 5) partial results.
__global__ void __launch_bounds__(kQueriesPerBlock)
knn5_partial_kernel(const float* __restrict__ query,
                    const float* __restrict__ cand,
                    const unsigned char* __restrict__ cand_valid,
                    float* __restrict__ part_d2, int* __restrict__ part_idx,
                    int Q, int M, int chunk) {
    __shared__ float4 tile[kTile];

    const int q = blockIdx.x * kQueriesPerBlock + threadIdx.x;
    const int qc = q < Q ? q : Q - 1;
    const float qx = query[3 * qc + 0];
    const float qy = query[3 * qc + 1];
    const float qz = query[3 * qc + 2];

    const int begin = blockIdx.y * chunk;
    const int end = min(M, begin + chunk);
    const float inf = __int_as_float(0x7f800000);

    Top5 best;
    best.init();

    for (int base = begin; base < end; base += kTile) {
        __syncthreads();
        for (int t = threadIdx.x; t < kTile; t += kQueriesPerBlock) {
            int g = base + t;
            float4 c = make_float4(inf, 0.f, 0.f, 0.f);   // never selected
            if (g < end && cand_valid[g]) {
                c.x = cand[3 * g + 0];
                c.y = cand[3 * g + 1];
                c.z = cand[3 * g + 2];
            }
            tile[t] = c;
        }
        __syncthreads();
        const int n = min(kTile, end - base);
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
            float4 c = tile[t];
            float dx = qx - c.x;
            float dy = qy - c.y;
            float dz = qz - c.z;
            float dist = dx * dx + dy * dy + dz * dz;
            best.insert(dist, base + t);
        }
    }

    if (q < Q) {
        const int splits = gridDim.y;
        const int o = (q * splits + blockIdx.y) * 5;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            part_d2[o + k] = best.d[k];
            part_idx[o + k] = best.i[k];
        }
    }
}

// One thread per query merges its `splits` sorted partial lists (slices are
// in ascending candidate order, so ties still go to the lower id) and
// blanks the distances of invalid queries.
__global__ void knn5_merge_kernel(const float* __restrict__ part_d2,
                                  const int* __restrict__ part_idx,
                                  const unsigned char* __restrict__ query_valid,
                                  int* __restrict__ out_idx,
                                  float* __restrict__ out_d2,
                                  int Q, int splits) {
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= Q) return;
    Top5 best;
    best.init();
    for (int s = 0; s < splits; ++s) {
        const int o = (q * splits + s) * 5;
#pragma unroll
        for (int k = 0; k < 5; ++k)
            best.insert(part_d2[o + k], part_idx[o + k]);
    }
    const bool valid = query_valid[q] != 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        out_idx[q * 5 + k] = best.d[k] < kFar ? best.i[k] : 0;
        out_d2[q * 5 + k] = valid ? best.d[k] : kFar;
    }
}

}  // namespace

extern "C" int knn5(const void* query, const void* query_valid,
                    const void* cand, const void* cand_valid,
                    void* part_d2, void* part_idx,
                    void* out_idx, void* out_d2,
                    int Q, int M, int splits, void* stream) {
    if (Q <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // slice length: a whole number of tiles, `splits` slices cover M
    int chunk = (M + splits - 1) / splits;
    chunk = ((chunk + kTile - 1) / kTile) * kTile;
    if (chunk < kTile) chunk = kTile;
    dim3 grid((Q + kQueriesPerBlock - 1) / kQueriesPerBlock, splits);
    knn5_partial_kernel<<<grid, kQueriesPerBlock, 0, s>>>(
        static_cast<const float*>(query), static_cast<const float*>(cand),
        static_cast<const unsigned char*>(cand_valid),
        static_cast<float*>(part_d2), static_cast<int*>(part_idx),
        Q, M, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 128;
    knn5_merge_kernel<<<(Q + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const float*>(part_d2), static_cast<const int*>(part_idx),
        static_cast<const unsigned char*>(query_valid),
        static_cast<int*>(out_idx), static_cast<float*>(out_d2), Q, splits);
    return static_cast<int>(cudaGetLastError());
}
