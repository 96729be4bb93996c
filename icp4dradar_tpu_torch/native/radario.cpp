// Native host-side radar frame loader with background prefetch (the port's
// own copy of icp4dradar_tpu/native/radario.cpp).
//
// The counterpart of the reference's C++ ingestion layer
// (read_radar_data, src/iterative_closest_point.cpp:64-82 — a synchronous
// whole-file read on the main loop): here a worker pool reads ahead
// `prefetch_depth` frames off the consumer's position and pads records into
// fixed-size buffers, so host IO overlaps device compute instead of
// stalling the pipeline between dispatches.
//
// Record format: float32[5] per point = (x, y, z, intensity, v_doppler),
// file naming data/radar_pointcloud_<k>.bin (:303-304). C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kFloatsPerPoint = 5;

struct Frame {
  std::vector<float> data;  // raw floats, n_points * 5
  int n_points = 0;
  bool ready = false;
};

struct Loader {
  std::string folder;
  int max_points;
  int prefetch_depth;
  int num_frames = 0;

  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::unordered_map<int, Frame> cache;
  std::atomic<int> consumer_pos{0};
  std::atomic<bool> stop{false};
  int next_fetch = 0;
  std::vector<std::thread> workers;

  std::string path_for(int order) const {
    return folder + "/data/radar_pointcloud_" + std::to_string(order) + ".bin";
  }

  static bool read_file(const std::string& path, Frame* out) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long bytes = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    size_t n_floats = static_cast<size_t>(bytes) / sizeof(float);
    size_t n_points = n_floats / kFloatsPerPoint;
    out->data.resize(n_points * kFloatsPerPoint);
    size_t got = std::fread(out->data.data(), sizeof(float),
                            n_points * kFloatsPerPoint, f);
    std::fclose(f);
    out->n_points = static_cast<int>(got / kFloatsPerPoint);
    out->ready = true;
    return true;
  }

  void worker_loop() {
    while (!stop.load()) {
      int order = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          if (stop.load()) return true;
          // fetch ahead of the consumer, bounded by prefetch_depth
          int pos = consumer_pos.load();
          if (next_fetch < pos) next_fetch = pos;
          return next_fetch < num_frames &&
                 next_fetch < pos + prefetch_depth &&
                 cache.find(next_fetch) == cache.end();
        });
        if (stop.load()) return;
        order = next_fetch++;
        cache.emplace(order, Frame{});  // claim
      }
      Frame frame;
      read_file(path_for(order), &frame);
      {
        std::lock_guard<std::mutex> lk(mu);
        cache[order] = std::move(frame);
        // bound the cache: drop frames far behind the consumer
        int pos = consumer_pos.load();
        for (auto it = cache.begin(); it != cache.end();) {
          if (it->first < pos - 2) it = cache.erase(it);
          else ++it;
        }
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* rl_open(const char* folder, int max_points, int prefetch_depth,
              int num_threads) {
  auto* l = new Loader();
  l->folder = folder;
  l->max_points = max_points;
  l->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 8;
  // count consecutive frames from 0 (reference stop-at-missing semantics)
  int n = 0;
  struct stat st;
  while (stat(l->path_for(n).c_str(), &st) == 0) n++;
  l->num_frames = n;
  int threads = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < threads; i++)
    l->workers.emplace_back([l] { l->worker_loop(); });
  return l;
}

int rl_num_frames(void* handle) {
  return static_cast<Loader*>(handle)->num_frames;
}

// Fills xyz[max_points*3], intensity[max_points], doppler[max_points]
// (zero-padded). Returns the number of valid points, or -1 on error.
int rl_load(void* handle, int order, float* xyz, float* intensity,
            float* doppler) {
  auto* l = static_cast<Loader*>(handle);
  if (order < 0 || order >= l->num_frames) return -1;
  {
    // store under the lock: a worker evaluating its cv_work.wait predicate
    // with the stale consumer value could otherwise miss this notify and
    // sleep until the next load call (lost wakeup, as in
    // bagio.cpp::bag_read_data)
    std::lock_guard<std::mutex> lk(l->mu);
    l->consumer_pos.store(order);
  }
  l->cv_work.notify_all();

  Frame frame;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    auto it = l->cache.find(order);
    if (it != l->cache.end()) {
      l->cv_done.wait(lk, [&] { return l->cache[order].ready; });
      frame = l->cache[order];
    }
  }
  if (!frame.ready) {
    if (!Loader::read_file(l->path_for(order), &frame)) return -1;
  }

  int n = frame.n_points < l->max_points ? frame.n_points : l->max_points;
  std::memset(xyz, 0, sizeof(float) * 3 * l->max_points);
  std::memset(intensity, 0, sizeof(float) * l->max_points);
  std::memset(doppler, 0, sizeof(float) * l->max_points);
  for (int i = 0; i < n; i++) {
    const float* rec = frame.data.data() + i * kFloatsPerPoint;
    xyz[i * 3 + 0] = rec[0];
    xyz[i * 3 + 1] = rec[1];
    xyz[i * 3 + 2] = rec[2];
    intensity[i] = rec[3];
    doppler[i] = rec[4];
  }
  return n;
}

void rl_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    // stop must flip under the mutex: a worker that already evaluated its
    // wait predicate (stop == false) but has not yet blocked would miss a
    // lock-free notify and sleep forever, deadlocking the join below
    // (Bag::~Bag in bagio.cpp does the same)
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop.store(true);
  }
  l->cv_work.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
