// Exact 5 nearest valid candidates per query, without the (Q, M) matrix:
// one launch for up to four independent searches.
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
// evaluations (268 M at 8192 x 32768, 8 flops each) run on the FP32 pipes,
// not the tensor cores: the norm-expansion form that a matrix unit could
// take cancels catastrophically far from the origin, and the callers gate on
// absolute distances.  Traffic is about 0.5 MB (queries, candidates, masks,
// 5 results per query).  In practice the code around the six
// floating-point operations of a pair decides the time (the scan runs about
// twelve machine operations a pair), and so does what happens whenever a
// distance has to enter a list.
//
// What the design does about it:
//
// * Several queries per thread (kR).  A thread keeps kR query points and kR
//   sorted top-5 lists (d2, id) in registers.  Candidates are read from
//   shared memory four at a time as three 16-byte broadcast loads (the packed
//   xyz of four points) plus one 4-byte load (their validity bytes); an
//   invalid candidate gets x = +inf once per thread, so its distance is +inf
//   (or NaN) for every query and never passes the `<` test.  Each candidate
//   then feeds kR independent distance chains.
// * No sorting and no branch in the scan.  A slice starts with empty lists,
//   so early on most candidates enter some list of a warp, and a sorted
//   insertion behind a divergent branch then costs several times the
//   distance arithmetic.  A branch per candidate is no better: it costs tens
//   of cycles whether taken or not.  Instead every distance is stored to the
//   next free slot of a small per-list buffer in shared memory, and the slot
//   is kept (the list's slot address moves on) only if the distance is under
//   its list's gate, the list's fifth entry as of the last flush: a store, a
//   compare and a predicated add.  When some list of the warp could not take
//   four more, the whole warp flushes: every lane sorts what waits into its
//   lists, in the order it came, with a branch-free insertion, and tightens
//   its gates.  The gate is never smaller than the list's true fifth entry,
//   so nothing that belongs in a list is turned away, and flushes grow rarer
//   as the scan goes on (the gate after k candidates passes about 5 in k).
// * Many small units of work.  A block is kThreads threads = kThreads * kR
//   queries, and the candidate range is cut into `splits` slices of `chunk`
//   candidates (a multiple of 16, chosen on the host from Q, M and the SM
//   count so that every SM holds several blocks even at Q = 1024).
// * Asynchronous candidate tiles.  A slice is walked in tiles of kTile
//   candidates through a ring of kStages shared-memory buffers filled with
//   cp.async (16 bytes a copy, straight from the contiguous (M, 3) float
//   array and the (M,) byte mask; the ragged end is zero-filled by the copy's
//   src-size operand, and a zero validity byte masks it), so tile t+kStages-1
//   loads while tile t is scanned.
// * One launch.  Each block writes its kR*kThreads partial lists to a scratch
//   buffer (L2-resident, three 16-byte words a list) and takes a ticket from
//   its query group's counter after a __threadfence().  The block that draws
//   the last ticket merges the `splits` lists of every query of the group
//   and writes the result; it resets the counter, so the scratch is ready for
//   the next launch on the stream.  Which block merges depends on timing;
//   WHAT it merges does not: every slice's list is complete and visible
//   before its ticket is taken, and the merge reads the slices in ascending
//   order.  So the result is the same whatever order the blocks finish in.
//   The merging block reads its group's lists alone, so it keeps several
//   slices' loads in flight and sorts only the few entries that can matter
//   (see merge_lists).
// * Several problems per launch.  The launch takes a small array of problem
//   descriptors by value (pointers, Q, M, geometry, first block); a block
//   finds its problem from blockIdx.x.  The scan-to-map solver sends its
//   corner and its surf search together this way.
//
// Exactness and ties: within a slice candidates are visited in ascending id
// and an equal distance never displaces an earlier entry (`<`), so a list
// holds the lower id of a tie; the merge visits slices in ascending id order
// with the same `<`, so the final list does too.  None of the TPU version's
// 16-lane group minima, 2 mm key quantisation, far-coordinate sentinel or
// M <= 32768 / M % 2048 limits is reproduced.
//
// Plain C interface, no allocation, no synchronisation; returns
// cudaGetLastError() for the wrapper to check.  Launches that share a scratch
// buffer must be ordered on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 64 threads x 2 queries was within 10 % of the best of a sweep over
// {32, 64, 128} x {1, 2, 4} at every shape the pipeline has (PERF.md).
constexpr int kThreads = 64;
constexpr int kR = 2;               // queries a thread
constexpr int kQueryBlock = kThreads * kR;
constexpr int kTile = 256;          // candidates a ring buffer holds
constexpr int kStages = 3;          // ring buffers
constexpr int kPending = 12;        // slots of a list's buffer
constexpr int kMaxProblems = 4;
constexpr int kSlotBytes = kR * kThreads * 8;   // one slot to the next
constexpr int kMergeBatch = 8 / kR > 0 ? 8 / kR : 1;   // slices loaded at once
constexpr float kFar = 3e38f;

static_assert(kTile % 16 == 0, "a tile is a whole number of 16-byte copies");
static_assert(kStages >= 2, "the ring needs two buffers to overlap anything");
static_assert(kPending > 5, "a list must hold five of a slice and more");

// One search.  `part` holds (qblocks, splits, kQueryBlock) lists of 6 entries
// {d2, id as bits} (five and one of padding, so a list is three 16-byte
// words); `tickets` one counter per query block, zero between launches.
// Field order and types are mirrored by ctypes in cuda_knn.py.
struct Problem {
    const float* query;
    const unsigned char* query_valid;
    const float* cand;
    const unsigned char* cand_valid;
    int* out_idx;
    float* out_d2;
    float4* part;
    unsigned int* tickets;
    int Q;
    int M;
    int splits;
    int chunk;
    int block_begin;
    int pad_;
};

struct Batch {
    Problem p[kMaxProblems];
    int n;
    int pad_;
};

struct Top5 {
    float d[5];
    int i[5];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int k = 0; k < 5; ++k) { d[k] = kFar; i[k] = 0; }
    }

    // Sorted insertion without a branch: every slot takes its own value, its
    // lower neighbour's or the new one.  An equal distance goes behind the
    // entries already there.
    __device__ __forceinline__ void insert(float dist, int id) {
        const bool lt0 = dist < d[0], lt1 = dist < d[1], lt2 = dist < d[2],
                   lt3 = dist < d[3], lt4 = dist < d[4];
        d[4] = lt4 ? (lt3 ? d[3] : dist) : d[4];
        i[4] = lt4 ? (lt3 ? i[3] : id) : i[4];
        d[3] = lt3 ? (lt2 ? d[2] : dist) : d[3];
        i[3] = lt3 ? (lt2 ? i[2] : id) : i[3];
        d[2] = lt2 ? (lt1 ? d[1] : dist) : d[2];
        i[2] = lt2 ? (lt1 ? i[1] : id) : i[2];
        d[1] = lt1 ? (lt0 ? d[0] : dist) : d[1];
        i[1] = lt1 ? (lt0 ? i[0] : id) : i[1];
        d[0] = lt0 ? dist : d[0];
        i[0] = lt0 ? id : i[0];
    }
};

// 16-byte asynchronous copy global -> shared; bytes past `src_bytes` (0..16)
// are written as zeros.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes) {
    uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(gmem_src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of candidates [base, base + n) into one ring buffer.  Every
// 16-byte piece that the scan of ceil(n / 4) groups will read is written:
// with data, with data then zeros, or with zeros only.
__device__ __forceinline__ void fetch_tile(float* s_xyz, unsigned char* s_valid,
                                           const float* cand,
                                           const unsigned char* cand_valid,
                                           int base, int n) {
    const int groups = (n + 3) >> 2;
    const char* gx = reinterpret_cast<const char*>(cand) + 12 * (size_t)base;
    char* sx = reinterpret_cast<char*>(s_xyz);
    const int xbytes = 12 * n;
    for (int c = threadIdx.x; c < 3 * groups; c += kThreads) {
        int left = xbytes - 16 * c;
        left = left < 0 ? 0 : (left > 16 ? 16 : left);
        cp_async16(sx + 16 * c, left ? gx + 16 * c : gx, left);
    }
    const unsigned char* gv = cand_valid + base;
    for (int c = threadIdx.x; c < (groups + 3) >> 2; c += kThreads) {
        int left = n - 16 * c;
        left = left < 0 ? 0 : (left > 16 ? 16 : left);
        cp_async16(s_valid + 16 * c, left ? gv + 16 * c : gv, left);
    }
}

// Store (dist, id) to the shared-memory slot at `slot`, and move on to the
// next slot of the list only if dist < gate: a compare, a predicated add and
// a store.
__device__ __forceinline__ void append(uint32_t& slot, float dist, float id,
                                       float gate) {
    asm volatile(
        "{\n"
        ".reg .pred keep;\n"
        "st.shared.v2.f32 [%0], {%1, %2};\n"
        "setp.lt.f32 keep, %1, %3;\n"
        "@keep add.u32 %0, %0, %4;\n"
        "}\n"
        : "+r"(slot) : "f"(dist), "f"(id), "f"(gate), "n"(kSlotBytes)
        : "memory");
}

// Sort what waits in shared memory into this thread's lists, in the order it
// came (ascending id), and tighten the gates.  The whole warp walks as many
// slots as its fullest list holds; a slot past a list's count reads as +inf.
__device__ __forceinline__ void flush(Top5 (&best)[kR], float (&gate)[kR],
                                      int (&pending)[kR],
                                      float2 (*waiting)[kR][kThreads]) {
    int most = pending[0];
#pragma unroll
    for (int r = 1; r < kR; ++r) most = max(most, pending[r]);
    most = __reduce_max_sync(0xffffffffu, most);
    const float inf = __int_as_float(0x7f800000);
    for (int e = 0; e < most; ++e) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            const float2 w = waiting[e][r][threadIdx.x];
            best[r].insert(e < pending[r] ? w.x : inf, __float_as_int(w.y));
        }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        pending[r] = 0;
        gate[r] = best[r].d[4];
    }
}

// This thread's kR lists to `dst`, the (kQueryBlock, 3) words of one slice.
__device__ __forceinline__ void store_lists(float4* dst, const Top5 (&best)[kR]) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        float4* mine = dst + (r * kThreads + threadIdx.x) * 3;
        const Top5& b = best[r];
        mine[0] = make_float4(b.d[0], __int_as_float(b.i[0]),
                              b.d[1], __int_as_float(b.i[1]));
        mine[1] = make_float4(b.d[2], __int_as_float(b.i[2]),
                              b.d[3], __int_as_float(b.i[3]));
        mine[2] = make_float4(b.d[4], __int_as_float(b.i[4]), kFar, 0.f);
    }
}

// Publish what this block wrote and take a ticket; true, for the whole
// block, in the block that takes the last of `total`.  That block resets the
// counter (every other block of the launch has been here), so the scratch is
// ready for the next launch on the stream, and may read what the others
// published.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter, int total,
                                               int* shared_flag) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int ticket = atomicAdd(counter, 1u);
        *shared_flag = ticket == (unsigned int)(total - 1);
        if (*shared_flag) *counter = 0u;
    }
    __syncthreads();
    const bool last = *shared_flag != 0;
    if (last) __threadfence();
    return last;
}

// Merge `count` slices' lists (`lists`: count x (kQueryBlock, 3) words) into
// `best`.  Five slices' nearest entries are five candidates, so the fifth
// smallest of the slices' heads bounds the final fifth distance; what lies
// at or under that bound (the answer and a few more of the 5 * count
// entries) goes through the same buffer and flush as in the scan.  A list is
// ascending, so its entries under the bound are a prefix: all five are
// stored and the count goes up by the length of the prefix.  Slices in
// ascending order keep ties with the lower id.  One block reads these lists
// alone, so the latency of L2 is what this costs: kMergeBatch slices' loads
// are in flight at a time.
__device__ __forceinline__ void merge_lists(
        const float4* lists, int count, Top5 (&best)[kR], float (&gate)[kR],
        int (&pending)[kR], float2 (*waiting)[kR][kThreads]) {
    const size_t list_words = (size_t)kQueryBlock * 3;
    const int tid = threadIdx.x;
    const float4* mine[kR];
    float bound[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        mine[r] = lists + (r * kThreads + tid) * 3;
        float t[5] = {kFar, kFar, kFar, kFar, kFar};     // ascending
        for (int s0 = 0; s0 < count; s0 += 4 * kMergeBatch) {
            float head[4 * kMergeBatch];
#pragma unroll
            for (int u = 0; u < 4 * kMergeBatch; ++u)
                head[u] = __ldcg(mine[r] + min(s0 + u, count - 1) * list_words).x;
#pragma unroll
            for (int u = 0; u < 4 * kMergeBatch; ++u) {
                const float x = s0 + u < count ? head[u] : kFar;
                t[4] = fminf(t[4], fmaxf(t[3], x));
                t[3] = fminf(t[3], fmaxf(t[2], x));
                t[2] = fminf(t[2], fmaxf(t[1], x));
                t[1] = fminf(t[1], fmaxf(t[0], x));
                t[0] = fminf(t[0], x);
            }
        }
        bound[r] = t[4];
        best[r].init();
        pending[r] = 0;
    }
    for (int s0 = 0; s0 < count; s0 += kMergeBatch) {
        float4 w[kMergeBatch][kR][3];
#pragma unroll
        for (int u = 0; u < kMergeBatch; ++u) {
            const int s = min(s0 + u, count - 1);
#pragma unroll
            for (int r = 0; r < kR; ++r) {
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    w[u][r][k] = __ldcg(mine[r] + s * list_words + k);
            }
        }
#pragma unroll
        for (int u = 0; u < kMergeBatch; ++u) {
            const bool real = s0 + u < count;
#pragma unroll
            for (int r = 0; r < kR; ++r) {
                const float d[5] = {w[u][r][0].x, w[u][r][0].z, w[u][r][1].x,
                                    w[u][r][1].z, w[u][r][2].x};
                const float id[5] = {w[u][r][0].y, w[u][r][0].w, w[u][r][1].y,
                                     w[u][r][1].w, w[u][r][2].y};
                int prefix = 0;
#pragma unroll
                for (int k = 0; k < 5; ++k) {
                    waiting[pending[r] + k][r][tid] = make_float2(d[k], id[k]);
                    prefix += (d[k] <= bound[r] && d[k] < kFar) ? 1 : 0;
                }
                pending[r] += real ? prefix : 0;
            }
            bool full = false;
#pragma unroll
            for (int r = 0; r < kR; ++r) full |= pending[r] > kPending - 5;
            if (__any_sync(0xffffffffu, full))
                flush(best, gate, pending, waiting);
        }
    }
    flush(best, gate, pending, waiting);
}

// Write one query's result: ids of real neighbours (0 in empty slots), and
// distances blanked for an invalid query.
__device__ __forceinline__ void write_result(const Problem& P, int q,
                                             const Top5& best) {
    if (q >= P.Q) return;
    const bool valid = P.query_valid[q] != 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        P.out_idx[q * 5 + k] = best.d[k] < kFar ? best.i[k] : 0;
        P.out_d2[q * 5 + k] = valid ? best.d[k] : kFar;
    }
}

__global__ void __launch_bounds__(kThreads)
knn5_kernel(const __grid_constant__ Batch batch) {
    __shared__ __align__(16) float s_xyz[kStages][kTile * 3];
    __shared__ __align__(16) unsigned char s_valid[kStages][kTile];
    __shared__ float2 s_pending[kPending][kR][kThreads];
    __shared__ int s_last;

    // which problem, which query block, which slice
    int pi = 0;
#pragma unroll
    for (int k = 1; k < kMaxProblems; ++k)
        if (k < batch.n && (int)blockIdx.x >= batch.p[k].block_begin) pi = k;
    const Problem& P = batch.p[pi];
    const int local = blockIdx.x - P.block_begin;
    const int qb = local / P.splits;
    const int slice = local - qb * P.splits;
    const int tid = threadIdx.x;

    float qx[kR], qy[kR], qz[kR];
    Top5 best[kR];
    float gate[kR];          // best[r].d[4] as of the last flush
    int pending[kR];         // entries of list r waiting in s_pending
    uint32_t slot0[kR];      // shared-memory address of list r's first slot
    uint32_t slot[kR];       // ... and of its next free one, during the scan
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        int q = qb * kQueryBlock + r * kThreads + tid;
        q = q < P.Q ? q : P.Q - 1;
        qx[r] = P.query[3 * q + 0];
        qy[r] = P.query[3 * q + 1];
        qz[r] = P.query[3 * q + 2];
        best[r].init();
        gate[r] = kFar;
        pending[r] = 0;
        slot0[r] = static_cast<uint32_t>(
            __cvta_generic_to_shared(&s_pending[0][r][tid]));
        slot[r] = slot0[r];
    }

    const int begin = slice * P.chunk;
    const int end = min(P.M, begin + P.chunk);
    const int tiles = end > begin ? (end - begin + kTile - 1) / kTile : 0;
    const float inf = __int_as_float(0x7f800000);

    // prologue: kStages - 1 tiles in flight (an empty group keeps the count)
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < tiles) {
            const int base = begin + s * kTile;
            fetch_tile(s_xyz[s], s_valid[s], P.cand, P.cand_valid, base,
                       min(kTile, end - base));
        }
        cp_async_commit();
    }

    for (int t = 0; t < tiles; ++t) {
        // the buffer refilled here was scanned in iteration t - 1, and the
        // barrier at the end of that iteration has been passed by everyone
        const int ahead = t + kStages - 1;
        if (ahead < tiles) {
            const int base = begin + ahead * kTile;
            fetch_tile(s_xyz[ahead % kStages], s_valid[ahead % kStages],
                       P.cand, P.cand_valid, base, min(kTile, end - base));
        }
        cp_async_commit();
        cp_async_wait<kStages - 1>();          // this thread's part of tile t
        __syncthreads();                       // everyone's part of tile t

        const int stage = t % kStages;
        const float4* x4 = reinterpret_cast<const float4*>(s_xyz[stage]);
        const uint32_t* v4 = reinterpret_cast<const uint32_t*>(s_valid[stage]);
        const int base = begin + t * kTile;
        const int groups = (min(kTile, end - base) + 3) >> 2;
        for (int g = 0; g < groups; ++g) {
            const float4 a = x4[3 * g + 0];
            const float4 b = x4[3 * g + 1];
            const float4 c = x4[3 * g + 2];
            const uint32_t v = v4[g];
            // four packed points: (a.x a.y a.z) (a.w b.x b.y) (b.z b.w c.x)
            // (c.y c.z c.w); +inf in x keeps an invalid one out of every list
            const float cx[4] = {(v & 0x000000ffu) ? a.x : inf,
                                 (v & 0x0000ff00u) ? a.w : inf,
                                 (v & 0x00ff0000u) ? b.z : inf,
                                 (v & 0xff000000u) ? c.y : inf};
            const float cy[4] = {a.y, b.x, b.w, c.z};
            const float cz[4] = {a.z, b.y, c.x, c.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float id = __int_as_float(base + 4 * g + j);
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                    const float dx = qx[r] - cx[j];
                    const float dy = qy[r] - cy[j];
                    const float dz = qz[r] - cz[j];
                    const float dist = dx * dx + dy * dy + dz * dz;
                    // no branch: the slot is always written, and kept only
                    // if the distance is under the gate
                    append(slot[r], dist, id, gate[r]);
                }
            }
            // room for the next group's four in every list of the warp?
            bool full = false;
#pragma unroll
            for (int r = 0; r < kR; ++r)
                full |= slot[r] > slot0[r] + (kPending - 4) * kSlotBytes;
            if (__any_sync(0xffffffffu, full)) {
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                    pending[r] = (slot[r] - slot0[r]) / kSlotBytes;
                    slot[r] = slot0[r];
                }
                flush(best, gate, pending, s_pending);
            }
        }
        __syncthreads();                       // done reading this buffer
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
        pending[r] = (slot[r] - slot0[r]) / kSlotBytes;
    flush(best, gate, pending, s_pending);

    if (P.splits == 1) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
            write_result(P, qb * kQueryBlock + r * kThreads + tid, best[r]);
        return;
    }

    // partial lists -> scratch, then a ticket; the last block of this query
    // group to arrive merges the group's lists
    const size_t list_words = (size_t)kQueryBlock * 3;
    float4* const lists = P.part + (size_t)qb * P.splits * list_words;
    store_lists(lists + slice * list_words, best);
    if (!last_to_arrive(P.tickets + qb, P.splits, &s_last)) return;
    merge_lists(lists, P.splits, best, gate, pending, s_pending);
#pragma unroll
    for (int r = 0; r < kR; ++r)
        write_result(P, qb * kQueryBlock + r * kThreads + tid, best[r]);
}

}  // namespace

// kThreads * kR: the wrapper cuts Q into blocks of this many queries.
extern "C" int knn5_query_block() { return kQueryBlock; }

// `batch` points at a host copy of Batch (see the struct above);
// `total_blocks` is the sum over problems of qblocks * splits.
extern "C" int knn5_batch(const void* batch, int total_blocks, void* stream) {
    if (total_blocks <= 0) return 0;
    const Batch* b = static_cast<const Batch*>(batch);
    if (b->n < 1 || b->n > kMaxProblems) return static_cast<int>(cudaErrorInvalidValue);
    knn5_kernel<<<total_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*b);
    return static_cast<int>(cudaGetLastError());
}
