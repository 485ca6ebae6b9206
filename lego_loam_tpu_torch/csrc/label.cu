// Connected-component labelling of the (V, H) range image on Hopper, in one
// kernel launch -- or of B such images, (B, V, H), in one launch for all B.
//
// Replaces the TPU kernel frontend/pallas_label.py::propagate_labels_pallas
// (body _kernel/_segmented_sweep) of the JAX package.  That kernel keeps the
// whole image in VMEM and iterates dense log-doubling min-scans to a fixed
// point; nothing of that shape is wanted here.  The contract is the output:
// every segmentable pixel gets the MINIMUM flat index of its component under
// the precomputed merge edges, every other pixel the sentinel 2^30.  The edge
// images come as one byte a pixel (torch.bool) or as int32; labels0 as int32.
//
// What bounds it on this card: neither bytes nor operations.  It reads
// V*H * (4 + 1 + 1) bytes and writes V*H * 4 (0.29 MB at 16x1800, 1.3 MB at
// 64x2083), a fraction of a microsecond at the card's memory rate.  What
// costs time is latency and the width of the machine that is used: every
// hop of a union-find walk is a dependent load (about 45 cycles in shared
// memory, 200 to 330 in another block's shared memory, more in global
// memory), concurrent unions of neighbouring pixels build chains as long as a
// wall is wide, lanes of a warp that leave a data-dependent loop at different
// points take turns from then on, and one SM alone needs tens of
// microseconds just to get through the work for 28,800 pixels.
//
// What the design does about it:
//
// * The union-find lives in shared memory, spread over a thread-block
//   cluster.  `label_cluster_kernel` runs as ONE cluster of up to 8 blocks of
//   1,024 threads; block b holds the parents (4 B) and bits (1 B) of a band
//   of whole rows, so the 16x1800 image is 8 bands of 2 rows and the 64x2083
//   image 8 bands of 8 rows (96 KB a block).  A parent is a flat pixel index.
//   The parent array never reaches global memory, the inputs are read once,
//   four pixels a load where the band's start allows, and the labels leave
//   in one coalesced store.
// * Horizontal runs need no union at all: a ballot inside each piece of 32
//   pixels and a running maximum over the pieces point every pixel of a run
//   straight at the run's first pixel, however wide the run is (label_tile
//   says how).  The H-1 <-> 0 wrap edge is an ordinary edge inside a band of
//   whole rows: one union a row.
// * Down edges are united only then, one for each pair of runs that touch
//   (an edge whose left neighbour joins the same two runs is skipped).
// * Every walk is written for a whole warp: all lanes step together until
//   none has anything left to do, so 32 unions cost as much as the longest
//   of them and not their sum.
// * Between bands, the lower block does the work.  After a cluster barrier it
//   fetches the parents and down bits of the row above its band in one sweep
//   of independent reads of the upper block's shared memory; a root up there
//   has the smaller index, so a union is one atomicMin on the lower band's
//   own root in its own memory, and only a root that had been given away
//   already needs a general union through the other block's memory.  After
//   a second barrier the few pixels that were roots of a band walk to their
//   final root (the only chains that cross bands); after a third, every
//   other pixel copies the label from its band root without leaving its
//   block.
// * B images in one launch (the lock-step multi-stream replay labels the
//   scans of all its streams at once; the counterpart of the TPU kernel under
//   jax.vmap, whose batching rule adds a grid axis): the cluster kernel runs
//   a grid of B clusters, and the cluster index picks the image, so each
//   image is labelled exactly as a launch of its own would label it.  The
//   tiled kernel walks the tiles of all B images in its one cooperative
//   launch (tile index = image * tiles of an image + tile), so it too takes
//   B images in one launch; its phases and grid barriers are shared.
// * An image too large for 8 bands of 227 KB goes through `label_grid_kernel`,
//   a cooperative launch of the same tile routine: tiles of at most
//   kTilePixels pixels (bands of whole rows where a row fits) are labelled in
//   shared memory, every pixel's tile-local root is written to the output as
//   a flat index, grid.sync(); the edges that cross a tile border are united
//   in global memory on that output array, grid.sync(); every pixel is
//   replaced by its root.  The output doubles as the global parent array, and
//   a block loops over tiles when there are more tiles than co-resident
//   blocks, so any (V, H) runs.
//
// Why the root is still the component's minimum flat index: a union always
// hangs the LARGER root under the SMALLER one with atomicMin, the initial
// parent (start of a run) is never larger than the pixel, and a tile-local
// index grows with the flat index inside a tile.  So every parent pointer
// points to a smaller-or-equal pixel of the same component, at every stage
// and in whatever order the unions land, and the root of a finished tree is
// its minimum.  Union-find always converges, so the result equals the
// fixed-point flood wherever that flood converged within its sweep cap.
//
// Plain C interface, no allocation, no synchronisation; returns
// cudaGetLastError() for the wrapper to check.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSentinel = 1 << 30;
constexpr int kBlockThreads = 1024;             // cluster kernel
constexpr int kMaxCluster = 8;                  // portable cluster size
constexpr int kMaxSharedBytes = 232448;         // 227 KB a block may take
constexpr int kTilePixels = 8192;               // tiled kernel
constexpr int kTileThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr unsigned char kRight = 1, kDown = 2, kJoined = 4, kRoot = 8,
                        kSeg = 16;                     // flag bits

// A rows x cols window of the image at (i0, j0), clipped to the image: every
// local index li in [0, rows * cols) is a pixel, row-major with width cols.
struct Tile {
    int i0, j0, rows, cols;
};

// Where a parent lives.  Flat: one array (shared or global), indexed by the
// pixel index less `first`.
struct Flat {
    int* parent;
    int first;
    __device__ __forceinline__ int* operator()(int x) const {
        return parent + (x - first);
    }
};

// Banded: pixel x lives in the shared memory of block x / band of the
// cluster; this block's own band starts at `first`.
struct Banded {
    int* mine;
    int first;
    int band;
    __device__ __forceinline__ int* operator()(int x) const {
        const unsigned off = (unsigned)(x - first);
        if (off < (unsigned)band) return mine + off;
        const int rank = x / band;
        return cg::this_cluster().map_shared_rank(mine, rank) + (x - rank * band);
    }
};

template <typename At>
__device__ __forceinline__ int load(const At& at, int x) {
    return *reinterpret_cast<const volatile int*>(at(x));
}

template <typename At>
__device__ __forceinline__ bool is_set(const At& at, int x) {
    return load(at, x) != kSentinel;
}

// The walks below are written for a whole warp at a time: every lane calls
// them together, `active` says which lanes have something to do, and each
// loop runs until no lane has.  A walk per lane with its own exits would be
// correct too, but lanes that leave a data-dependent loop at different
// points do not run together again until the end of the function, and 32
// unions then take 32 turns.

// Root of x's tree (for an active lane), read only.
template <typename At>
__device__ __forceinline__ int find_root(const At& at, bool active, int x) {
    // parents only ever decrease, so this walk terminates at a root
    while (__any_sync(kFullMask, active)) {
        if (active) {
            const int p = load(at, x);
            active = p != x;
            x = p;
        }
    }
    return x;
}

// Join the trees of a and b (for an active lane).
template <typename At>
__device__ __forceinline__ void unite(const At& at, bool active, int a, int b) {
    while (__any_sync(kFullMask, active)) {
        if (active) {
            const int pa = load(at, a), pb = load(at, b);
            if (pa != a || pb != b) {           // one step up on both sides
                a = pa;
                b = pb;
            } else if (a == b) {
                active = false;
            } else {
                const int hi = a > b ? a : b;
                const int lo = a > b ? b : a;
                const int old = atomicMin(at(hi), lo);
                // old == hi: hi was still a root and now hangs under lo.
                // Else another thread had hung hi under `old` (< hi); its
                // parent is now min(old, lo), and the other of the two
                // still has to be joined to that tree.
                active = old != hi;
                a = old;
                b = lo;
            }
        }
    }
}

// Four consecutive edge flags in one load.
template <typename Edge>
struct Four {
    bool v[4];
};

__device__ __forceinline__ Four<unsigned char> load_four(
        const unsigned char* __restrict__ edges, int quad) {
    const uchar4 e = reinterpret_cast<const uchar4*>(edges)[quad];
    return {{e.x != 0, e.y != 0, e.z != 0, e.w != 0}};
}

__device__ __forceinline__ Four<int> load_four(const int* __restrict__ edges,
                                               int quad) {
    const int4 e = reinterpret_cast<const int4*>(edges)[quad];
    return {{e.x != 0, e.y != 0, e.z != 0, e.w != 0}};
}

// Shared memory of one tile of n pixels: parents, per-pixel bits, and two
// words for every 32 pixels.
struct TileMemory {
    int* loc;               // n parents
    int* piece_last;        // ceil(n / 32): see label_tile
    int* piece_enter;       // ceil(n / 32)
    unsigned char* flags;   // n bytes
    int* above;             // cluster kernel only: one row of the band above
};

__host__ __device__ constexpr size_t tile_bytes(size_t n) {
    return 4 * n + 8 * ((n + 31) / 32) + 4 * ((n + 3) / 4);
}

__device__ __forceinline__ TileMemory carve(int* base, int n) {
    const int pieces = (n + 31) / 32;
    TileMemory m;
    m.loc = base;
    m.piece_last = base + n;
    m.piece_enter = base + n + pieces;
    m.flags = reinterpret_cast<unsigned char*>(base + n + 2 * pieces);
    m.above = base + n + 2 * pieces + (n + 3) / 4;
    return m;
}

constexpr int kThrough = -1;    // "this run began before the piece"

// Union-find of one tile in shared memory.  Pixel li of the tile has the
// index `first + li`, and loc[li] holds such an index; on return (after a
// barrier) loc is a forest whose roots are the minima of the tile-local
// components, or the sentinel.  `flags` keeps each pixel's bits (kSeg:
// segmentable; kRight, kDown: its edges; kJoined: joined to the pixel before
// it in its row) for the later passes, so global memory is read once.
//
// Horizontal runs need no union at all.  A warp takes a piece of 32
// consecutive pixels; one ballot gives every lane the first pixel of its run
// inside the piece, or kThrough if the run began before it.  The start of
// the run that reaches a piece's last pixel is that piece's word in
// piece_last; an exclusive running maximum over those words (kThrough is
// smaller than any index) is, for a piece whose first pixel continues a run,
// the start of that run.  So after three passes every pixel of a run points
// straight at the run's first pixel, however wide the run is.
template <typename Edge>
__device__ __forceinline__ void label_tile(
        const TileMemory m, const int first,
        const int* __restrict__ labels0, const Edge* __restrict__ right,
        const Edge* __restrict__ down, int H, const Tile t,
        const bool full_width) {
    int* const loc = m.loc;
    unsigned char* const flags = m.flags;
    const Flat at = {loc, first};
    const int npx = t.rows * t.cols;
    const int pieces = (npx + 31) / 32;
    const int lane = threadIdx.x & 31;
    const int warp0 = threadIdx.x - lane;       // the warp's first pixel

    // 0. the inputs, once: each pixel's bits go to shared memory.  A band of
    //    whole rows is one contiguous range of the image and is read four
    //    pixels a load where its start allows (one SM can only start so many
    //    loads, and a byte per lane wastes most of each).
    const int g0 = t.i0 * H + t.j0;
    int done = 0;
    // four pixels a load need 16-byte labels and 4-pixel edges aligned: an
    // image of a batch starts wherever the images before it end
    const bool aligned =
        (reinterpret_cast<size_t>(labels0 + g0) & 15) == 0
        && (reinterpret_cast<size_t>(right + g0) & (4 * sizeof(Edge) - 1)) == 0
        && (reinterpret_cast<size_t>(down + g0) & (4 * sizeof(Edge) - 1)) == 0;
    if (t.cols == H && aligned) {
        const int quads = npx >> 2;
        const int4* lab4 = reinterpret_cast<const int4*>(labels0 + g0);
        for (int q = threadIdx.x; q < quads; q += blockDim.x) {
            const int4 lab = lab4[q];
            const Four<Edge> r = load_four(right + g0, q);
            const Four<Edge> d = load_four(down + g0, q);
            const int g = g0 + 4 * q;
            uchar4 bits;
            bits.x = (lab.x == g ? kSeg : 0) | (r.v[0] ? kRight : 0) | (d.v[0] ? kDown : 0);
            bits.y = (lab.y == g + 1 ? kSeg : 0) | (r.v[1] ? kRight : 0) | (d.v[1] ? kDown : 0);
            bits.z = (lab.z == g + 2 ? kSeg : 0) | (r.v[2] ? kRight : 0) | (d.v[2] ? kDown : 0);
            bits.w = (lab.w == g + 3 ? kSeg : 0) | (r.v[3] ? kRight : 0) | (d.v[3] ? kDown : 0);
            reinterpret_cast<uchar4*>(flags)[q] = bits;
        }
        done = quads << 2;
    }
    for (int li = done + threadIdx.x; li < npx; li += blockDim.x) {
        const int r = li / t.cols;
        const int g = (t.i0 + r) * H + t.j0 + li - r * t.cols;
        flags[li] = (labels0[g] == g ? kSeg : 0) | (right[g] != 0 ? kRight : 0)
            | (down[g] != 0 ? kDown : 0);
    }
    __syncthreads();

    // 1. runs inside a piece.  The column is carried along instead of being
    //    divided out for every pixel.
    const int col_step = blockDim.x % t.cols;
    int col = threadIdx.x % t.cols;
    for (int base = warp0; base < npx; base += blockDim.x) {
        const int li = base + lane;
        const bool in = li < npx;
        const unsigned char bits = in ? flags[li] : 0;
        const bool seg = bits & kSeg;
        const unsigned seg_m = __ballot_sync(kFullMask, seg);
        const unsigned edge_m = __ballot_sync(kFullMask, bits & kRight);
        // joined to the pixel before it in its row
        bool joined = seg && col > 0;
        if (joined) {
            const unsigned before = lane == 0
                ? (flags[li - 1] & (kSeg | kRight)) == (kSeg | kRight)
                : ((seg_m & edge_m) >> (lane - 1)) & 1u;
            joined = before != 0;
        }
        const unsigned joined_m = __ballot_sync(kFullMask, joined);
        // highest lane at or below this one that starts a run
        const unsigned starts = ~joined_m & (kFullMask >> (31 - lane));
        const int start = starts ? first + base + 31 - __clz(starts)
                                 : kThrough;
        if (in) {
            loc[li] = seg ? start : kSentinel;
            if (joined) flags[li] = bits | kJoined;
        }
        // a pixel that is not segmentable ends every run: its own index
        // keeps the running maximum in step
        if (lane == 31) m.piece_last[base >> 5] = seg ? start : first + li;
        col += col_step;
        if (col >= t.cols) col -= t.cols;
    }
    __syncthreads();

    // 2. exclusive running maximum of piece_last, by the first warp
    if (threadIdx.x < 32) {
        int carry = kThrough;
        for (int p0 = 0; p0 < pieces; p0 += 32) {
            const int p = p0 + lane;
            const int mine = p < pieces ? m.piece_last[p] : kThrough;
            int run = mine;                    // inclusive maximum
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int other = __shfl_up_sync(kFullMask, run, d);
                if (lane >= d) run = max(run, other);
            }
            int before = __shfl_up_sync(kFullMask, run, 1);
            before = lane == 0 ? carry : max(before, carry);
            if (p < pieces) m.piece_enter[p] = before;
            carry = max(carry, __shfl_sync(kFullMask, run, 31));
        }
    }
    __syncthreads();

    // 3. runs that began before their piece; then the wrap column, where
    //    the tile holds both of its ends (the one union a row needs)
    for (int li = threadIdx.x; li < npx; li += blockDim.x)
        if (loc[li] == kThrough) loc[li] = m.piece_enter[li >> 5];
    __syncthreads();
    if (full_width && t.cols > 1) {
        for (int r0 = warp0; r0 < t.rows; r0 += blockDim.x) {
            const int r = r0 + lane;
            const int a = r * t.cols, b = a + t.cols - 1;
            const bool edge = r < t.rows && (flags[b] & kRight)
                && loc[a] != kSentinel && loc[b] != kSentinel;
            unite(at, edge, first + b, first + a);
        }
        __syncthreads();
    }

    // 4. down edges.  One is skipped when the edge of the pixel before it
    //    joins the same two runs.
    for (int base = warp0; base + t.cols < npx; base += blockDim.x) {
        const int li = base + lane;
        bool edge = false;
        if (li + t.cols < npx) {
            const unsigned char bits = flags[li];
            edge = (bits & kDown) && loc[li] != kSentinel
                && loc[li + t.cols] != kSentinel
                && !((bits & kJoined) && (flags[li - 1] & kDown)
                     && (flags[li + t.cols] & kJoined));
        }
        unite(at, edge, first + li, first + li + t.cols);
    }
    __syncthreads();
}

// One cluster; block b labels rows [b * band_rows, ...) in its own shared
// memory (TileMemory of band_rows * H pixels), then the bands are joined
// through distributed shared memory.
template <typename Edge>
__global__ void __launch_bounds__(kBlockThreads)
label_cluster_kernel(const int* __restrict__ labels0,
                     const Edge* __restrict__ right,
                     const Edge* __restrict__ down, int* __restrict__ out,
                     int V, int H, int band_rows) {
    extern __shared__ int loc[];
    cg::cluster_group cluster = cg::this_cluster();
    // one cluster an image: the clusters tile the grid along x
    const size_t image = (size_t)(blockIdx.x / cluster.num_blocks()) * V * H;
    labels0 += image;
    right += image;
    down += image;
    out += image;
    const int band = band_rows * H;
    const int i0 = (int)cluster.block_rank() * band_rows;
    const int rows = min(band_rows, V - i0);
    const int first = i0 * H;
    const int npx = rows * H;
    const Tile t = {i0, 0, rows, H};
    const TileMemory m = carve(loc, band);
    label_tile(m, first, labels0, right, down, H, t, true);
    if (cluster.num_blocks() > 1) {
        // flat once more, so that equal parents mean equal trees below; the
        // band's roots are marked
        const int lane = threadIdx.x & 31;
        const int warp0 = threadIdx.x - lane;
        const Flat local = {loc, first};
        unsigned char* const flags = m.flags;
        for (int base = warp0; base < npx; base += blockDim.x) {
            const int li = base + lane;
            const bool seg = li < npx && loc[li] != kSentinel;
            const int root = find_root(local, seg, first + li);
            if (seg) {
                loc[li] = root;
                if (root == first + li) flags[li] |= kRoot;
            }
        }
        cluster.sync();                  // every band's forest is in place
        // The first row's edges from above.  The row above lives in the
        // previous block: its parents (band roots, after the pass above) and
        // down bits are fetched in one sweep of independent remote loads.
        // A root up there has the smaller index, so the union is one local
        // atomicMin on this band's root; only if that root had been given
        // away already does a general union follow.
        const Banded at = {loc, first, band};
        if (i0 > 0) {
            int* const above = m.above;
            const int* up_loc = cluster.map_shared_rank(loc, cluster.block_rank() - 1);
            const unsigned char* up_flags = reinterpret_cast<const unsigned char*>(
                cluster.map_shared_rank(reinterpret_cast<int*>(flags),
                                        cluster.block_rank() - 1));
            const int up_row = band - H;     // the band above is a full one
            for (int c = threadIdx.x; c < H; c += blockDim.x) {
                const int parent = up_loc[up_row + c];
                const bool joins = (up_flags[up_row + c] & kDown)
                    && parent != kSentinel && loc[c] != kSentinel;
                above[c] = joins ? parent : kSentinel;
            }
            __syncthreads();
            for (int c0 = warp0; c0 < H; c0 += blockDim.x) {
                const int c = c0 + lane;
                bool more = false;
                int other = 0, upper = 0;
                // this band's root over pixel c (a root's own word may
                // already name a pixel of another band)
                const int mine = c >= H ? 0
                    : (flags[c] & kRoot) ? first + c : loc[c];
                if (c < H && above[c] != kSentinel
                        && !(c > 0 && above[c - 1] == above[c]
                             && !(flags[c] & kRoot) && loc[c - 1] == mine)) {
                    upper = above[c];
                    other = atomicMin(loc + (mine - first), upper);
                    more = other != mine && other != upper;
                }
                unite(at, more, other, upper);
            }
        }
        cluster.sync();                  // all unions have landed
        // the band's roots learn their final root (a walk through other
        // bands' memory, for the few pixels that were roots) ...
        for (int base = warp0; base < npx; base += blockDim.x) {
            const int li = base + lane;
            const bool was_root = li < npx && (flags[li] & kRoot);
            const int root = find_root(at, was_root, first + li);
            if (was_root) loc[li] = root;     // still an ancestor for walkers
        }
        cluster.sync();                  // nobody reads another band any more
        // ... and every other pixel copies it from its band root
        for (int li = threadIdx.x; li < npx; li += blockDim.x) {
            int label = loc[li];
            if (label != kSentinel && !(flags[li] & kRoot))
                label = loc[label - first];
            out[first + li] = label;
        }
    } else {
        const Flat at = {loc, 0};
        for (int base = threadIdx.x & ~31; base < npx; base += blockDim.x) {
            const int li = base + (threadIdx.x & 31);
            const bool seg = li < npx && loc[li] != kSentinel;
            const int root = find_root(at, seg, li);
            if (li < npx) out[li] = seg ? root : kSentinel;
        }
    }
}

__device__ __forceinline__ Tile tile_at(int index, int tiles_x, int tile_rows,
                                        int tile_cols, int V, int H) {
    const int ty = index / tiles_x;
    const int tx = index - ty * tiles_x;
    Tile t;
    t.i0 = ty * tile_rows;
    t.j0 = tx * tile_cols;
    t.rows = min(tile_rows, V - t.i0);
    t.cols = min(tile_cols, H - t.j0);
    return t;
}

// Any image: tiles of tile_rows x tile_cols <= kTilePixels pixels in shared
// memory, tile borders in global memory.  Cooperative launch; `out` is the
// global parent array between the phases.
template <typename Edge>
__global__ void __launch_bounds__(kTileThreads)
label_grid_kernel(const int* __restrict__ labels0,
                  const Edge* __restrict__ right,
                  const Edge* __restrict__ down, int* out, int B, int V,
                  int H, int tile_rows, int tile_cols) {
    __shared__ int words[tile_bytes(kTilePixels) / 4];
    const TileMemory m = carve(words, kTilePixels);
    int* const loc = m.loc;
    cg::grid_group grid = cg::this_grid();
    const int tiles_x = (H + tile_cols - 1) / tile_cols;
    const int image_tiles = tiles_x * ((V + tile_rows - 1) / tile_rows);
    const int tiles = B * image_tiles;
    const int n = V * H;
    const bool full_width = tiles_x == 1;
    const Flat local = {loc, 0};
    const int lane = threadIdx.x & 31;
    const int warp0 = threadIdx.x - lane;

    // 1. tile-local forests; out[g] = tile-local root as a flat index of
    //    the tile's image
    for (int index = blockIdx.x; index < tiles; index += gridDim.x) {
        const int image = index / image_tiles;
        const size_t at0 = (size_t)image * n;
        const Tile t = tile_at(index - image * image_tiles, tiles_x, tile_rows,
                               tile_cols, V, H);
        label_tile(m, 0, labels0 + at0, right + at0, down + at0, H, t,
                   full_width);
        int* const img_out = out + at0;
        const int npx = t.rows * t.cols;
        for (int base = warp0; base < npx; base += blockDim.x) {
            const int li = base + lane;
            const bool seg = li < npx && loc[li] != kSentinel;
            const int root = find_root(local, seg, li);
            if (li < npx) {
                const int r = li / t.cols;
                const int rr = root / t.cols;
                img_out[(t.i0 + r) * H + t.j0 + li - r * t.cols] = seg
                    ? (t.i0 + rr) * H + t.j0 + root - rr * t.cols : kSentinel;
            }
        }
        __syncthreads();                         // loc is reused
    }
    grid.sync();

    // 2. edges that leave a tile: right from its last column (the wrap edge
    //    among them) unless the tile spans the width, down from its last
    //    row.  A down edge is skipped when the edge of the pixel before it
    //    joins the same two trees (equal parents on both sides).
    for (int index = blockIdx.x; index < tiles; index += gridDim.x) {
        const int image = index / image_tiles;
        const size_t at0 = (size_t)image * n;
        const Tile t = tile_at(index - image * image_tiles, tiles_x, tile_rows,
                               tile_cols, V, H);
        const Flat global = {out + at0, 0};
        const Edge* const img_right = right + at0;
        const Edge* const img_down = down + at0;
        for (int k0 = warp0; k0 < t.rows + t.cols; k0 += blockDim.x) {
            const int k = k0 + lane;
            bool edge = false;
            int g = 0, q = 0;
            if (k < t.rows) {
                const int i = t.i0 + k;
                const int j = t.j0 + t.cols - 1;
                g = i * H + j;
                q = i * H + (j + 1 == H ? 0 : j + 1);
                edge = !full_width && img_right[g] != 0 && is_set(global, g)
                    && is_set(global, q);
            } else if (k < t.rows + t.cols) {
                const int i = t.i0 + t.rows - 1;
                const int c = k - t.rows;
                g = i * H + t.j0 + c;
                q = g + H;
                edge = i + 1 < V && img_down[g] != 0 && is_set(global, g)
                    && is_set(global, q);
                if (edge && c > 0 && img_down[g - 1] != 0
                        && load(global, g - 1) == load(global, g)
                        && load(global, q - 1) == load(global, q))
                    edge = false;
            }
            unite(global, edge, g, q);
        }
    }
    grid.sync();

    // 3. every pixel to its root.  In place: a pixel overwritten with its
    //    root still points to an ancestor, so walks through it stay valid.
    //    The lanes of a warp may hold pixels of two images: each walks in
    //    its own image's array.
    const int total = B * n;
    for (int base = blockIdx.x * blockDim.x + warp0; base < total;
         base += gridDim.x * blockDim.x) {
        const int p = base + lane;
        const int image = p < total ? p / n : 0;
        const int x = p - image * n;
        const Flat global = {out + (size_t)image * n, 0};
        const bool seg = p < total && is_set(global, x);
        const int root = find_root(global, seg, x);
        if (seg) out[p] = root;
    }
}

// Blocks of the tiled kernel that can be resident together on `device`.
template <typename Edge>
int resident_blocks(int device) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
            != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, label_grid_kernel<Edge>, kTileThreads, 0)
            != cudaSuccess)
        return 0;
    return sms * per_sm;
}

// The image size picks the kernel: the cluster kernel, with as many bands as
// rows allow up to kMaxCluster, if a band fits one block's shared memory;
// else the tiled kernel.  Nothing else does.
template <typename Edge>
int launch(const void* labels0_, const void* right_, const void* down_,
           void* out_, int B, int V, int H, cudaStream_t stream) {
    const int* labels0 = static_cast<const int*>(labels0_);
    const Edge* right = static_cast<const Edge*>(right_);
    const Edge* down = static_cast<const Edge*>(down_);
    int* out = static_cast<int*>(out_);
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 0 || device >= kMaxDevices)
        return static_cast<int>(cudaErrorInvalidDevice);

    const int want = V < kMaxCluster ? V : kMaxCluster;
    int band_rows = (V + want - 1) / want;
    const int bands = (V + band_rows - 1) / band_rows;
    const size_t band = (size_t)band_rows * H;
    if (tile_bytes(band) + 4 * (size_t)H <= (size_t)kMaxSharedBytes) {
        static bool raised[kMaxDevices] = {false};      // asked once a device
        if (!raised[device]) {
            err = cudaFuncSetAttribute(
                label_cluster_kernel<Edge>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
            if (err != cudaSuccess) return static_cast<int>(err);
            raised[device] = true;
        }
        cudaLaunchConfig_t config = {};
        config.gridDim = dim3(bands * B);        // B clusters of `bands`
        config.blockDim = dim3(kBlockThreads);
        config.dynamicSmemBytes = tile_bytes(band) + 4 * (size_t)H;
        config.stream = stream;
        cudaLaunchAttribute attribute[1];
        attribute[0].id = cudaLaunchAttributeClusterDimension;
        attribute[0].val.clusterDim.x = bands;
        attribute[0].val.clusterDim.y = 1;
        attribute[0].val.clusterDim.z = 1;
        config.attrs = attribute;
        config.numAttrs = 1;
        err = cudaLaunchKernelEx(&config, label_cluster_kernel<Edge>, labels0,
                                 right, down, out, V, H, band_rows);
        return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
    }

    static int resident[kMaxDevices] = {0};            // asked once a device
    if (resident[device] == 0) resident[device] = resident_blocks<Edge>(device);
    if (resident[device] <= 0)
        return static_cast<int>(cudaErrorLaunchOutOfResources);
    // bands of whole rows where a row fits a tile (horizontal runs and the
    // wrap edge stay tile-local), else row pieces
    int tile_cols = H < kTilePixels ? H : kTilePixels;
    int tile_rows = kTilePixels / tile_cols;
    if (tile_rows > V) tile_rows = V;
    const size_t tiles = (size_t)B * ((H + tile_cols - 1) / tile_cols)
        * ((V + tile_rows - 1) / tile_rows);
    // more blocks than tiles help the two passes over global memory
    size_t want_grid = ((size_t)B * V * H + 4 * kTileThreads - 1)
        / (4 * kTileThreads);
    if (want_grid < tiles) want_grid = tiles;
    const int grid = want_grid < (size_t)resident[device]
        ? (int)want_grid : resident[device];
    void* args[] = {&labels0, &right, &down, &out, &B, &V, &H, &tile_rows,
                    &tile_cols};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(label_grid_kernel<Edge>), dim3(grid),
        dim3(kTileThreads), args, 0, stream);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// B images of (V, H), contiguous; edge_bytes: 1 (bool / uint8 edge images)
// or 4 (int32).  The caller keeps B * V * H below 2^31.
extern "C" int label_ccl(const void* labels0, const void* right,
                         const void* down, void* out, int B, int V, int H,
                         int edge_bytes, void* stream) {
    if (B <= 0 || V <= 0 || H <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (edge_bytes == 1)
        return launch<unsigned char>(labels0, right, down, out, B, V, H, s);
    if (edge_bytes == 4)
        return launch<int>(labels0, right, down, out, B, V, H, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
