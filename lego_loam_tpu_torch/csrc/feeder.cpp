// Host-side native runtime: scan packing + bounded MPMC channel.
//
// The port's own copy of the JAX package's native/feeder.cpp, with the same
// C ABI; built with the host compiler (not nvcc) by
// lego_loam_tpu_torch/hostlib.py into build/libfeeder.so.
//  * Channel<T> (LeGO-LOAM/include/lego_loam/channel.h:11-56) — here a
//    bounded blocking queue of scan slots, depth-1 by default for the
//    same deterministic lock-step replay the BOR fork built;
//  * the rosbag driver loop's message unpacking (src/main.cpp:59-95) —
//    here pack_scan(): NaN-filter + fixed-capacity padding of raw float32
//    xyz records into the layout the device pipeline consumes.  This is
//    the per-scan host hot path (28.8K points @ up to 100+ scans/s), kept
//    native so the Python feeder thread never touches per-point data.
//
// Exposed as a plain C ABI for ctypes.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- pack

// Pack raw points (n x 3 float32, NaN/inf rows invalid) into a fixed
// capacity buffer + validity mask. Returns number of valid points.
int64_t lego_pack_scan(const float* pts, int64_t n, int64_t capacity,
                       float* out_xyz, uint8_t* out_valid) {
  int64_t limit = n < capacity ? n : capacity;
  int64_t n_valid = 0;
  std::memset(out_xyz, 0, sizeof(float) * 3 * capacity);
  std::memset(out_valid, 0, capacity);
  for (int64_t i = 0; i < limit; ++i) {
    float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    bool ok = std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
    if (ok) {
      out_xyz[3 * i] = x;
      out_xyz[3 * i + 1] = y;
      out_xyz[3 * i + 2] = z;
      out_valid[i] = 1;
      ++n_valid;
    }
  }
  return n_valid;
}

// ------------------------------------------------------------- channel

// Bounded blocking channel of fixed-size scan slots (xyz + valid + stamp).
struct LegoChannel {
  int64_t capacity_points;
  int64_t depth;
  std::vector<std::vector<float>> xyz;       // depth x (3*capacity)
  std::vector<std::vector<uint8_t>> valid;   // depth x capacity
  std::vector<double> stamp;
  int64_t head = 0, tail = 0, count = 0;
  bool closed = false;
  std::mutex mu;
  std::condition_variable cv_send, cv_recv;
};

void* lego_channel_create(int64_t capacity_points, int64_t depth) {
  auto* ch = new LegoChannel();
  ch->capacity_points = capacity_points;
  ch->depth = depth;
  ch->xyz.assign(depth, std::vector<float>(3 * capacity_points));
  ch->valid.assign(depth, std::vector<uint8_t>(capacity_points));
  ch->stamp.assign(depth, 0.0);
  return ch;
}

void lego_channel_destroy(void* handle) {
  delete static_cast<LegoChannel*>(handle);
}

// Blocking send (packs in-place into the slot). Returns 0 on success,
// -1 if the channel is closed.
int lego_channel_send(void* handle, const float* pts, int64_t n,
                      double stamp) {
  auto* ch = static_cast<LegoChannel*>(handle);
  std::unique_lock<std::mutex> lk(ch->mu);
  ch->cv_send.wait(lk, [&] { return ch->count < ch->depth || ch->closed; });
  if (ch->closed) return -1;
  int64_t slot = ch->tail;
  lego_pack_scan(pts, n, ch->capacity_points, ch->xyz[slot].data(),
                 ch->valid[slot].data());
  ch->stamp[slot] = stamp;
  ch->tail = (ch->tail + 1) % ch->depth;
  ++ch->count;
  ch->cv_recv.notify_one();
  return 0;
}

// Blocking receive into caller buffers. Returns 0 on success, -1 if the
// channel is closed and drained.
int lego_channel_recv(void* handle, float* out_xyz, uint8_t* out_valid,
                      double* out_stamp) {
  auto* ch = static_cast<LegoChannel*>(handle);
  std::unique_lock<std::mutex> lk(ch->mu);
  ch->cv_recv.wait(lk, [&] { return ch->count > 0 || ch->closed; });
  if (ch->count == 0) return -1;
  int64_t slot = ch->head;
  std::memcpy(out_xyz, ch->xyz[slot].data(),
              sizeof(float) * 3 * ch->capacity_points);
  std::memcpy(out_valid, ch->valid[slot].data(), ch->capacity_points);
  *out_stamp = ch->stamp[slot];
  ch->head = (ch->head + 1) % ch->depth;
  --ch->count;
  ch->cv_send.notify_one();
  return 0;
}

void lego_channel_close(void* handle) {
  auto* ch = static_cast<LegoChannel*>(handle);
  std::lock_guard<std::mutex> lk(ch->mu);
  ch->closed = true;
  ch->cv_send.notify_all();
  ch->cv_recv.notify_all();
}

int64_t lego_channel_size(void* handle) {
  auto* ch = static_cast<LegoChannel*>(handle);
  std::lock_guard<std::mutex> lk(ch->mu);
  return ch->count;
}

}  // extern "C"
