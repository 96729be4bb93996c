// Native ROS1 rosbag (v2.0) record streamer with background prefetch (the
// port's own copy of icp4dradar_tpu/native/bagio.cpp).
//
// The counterpart of the reference's C++ rosbag ingestion
// (rosbag::View loop, src/radar_odometry.cpp:244-308). The Python layer
// (io/rosbag.py) keeps the message decoding (PointCloud2/Imu/Odometry ->
// numpy); this library owns the container work that benefits from native
// threads: one synchronous pass builds a record index (offset/op/
// compression/uncompressed size from each record header), then a worker
// pool reads + bz2-decompresses chunk records AHEAD of the consumer so
// disk IO and decompression overlap Python-side decoding and device
// compute (same pattern as the .bin loader, radario.cpp).
//
// bz2 and lz4 are resolved at runtime via dlopen("libbz2.so.1" /
// "liblz4.so.1"), so only the runtime libraries are needed, no -dev
// files. lz4 chunks are standard LZ4 frames (roslz4), decoded with the
// LZ4F streaming API. Unsupported compression or a missing library
// surfaces as comp_ok = 0 in bag_record_info, before any record is read;
// the Python reader then takes its own path.
//
// C ABI (ctypes): bag_open / bag_record_count / bag_record_info /
// bag_read_header / bag_read_data / bag_advance / bag_close.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

typedef int (*bz2_decomp_fn)(char*, unsigned*, char*, unsigned, int, int);

bz2_decomp_fn load_bz2() {
  static bz2_decomp_fn fn = []() -> bz2_decomp_fn {
    void* lib = dlopen("libbz2.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) lib = dlopen("libbz2.so.1.0", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return nullptr;
    return reinterpret_cast<bz2_decomp_fn>(
        dlsym(lib, "BZ2_bzBuffToBuffDecompress"));
  }();
  return fn;
}

// LZ4 frame API (subset), loaded at runtime
struct Lz4Api {
  size_t (*create_dctx)(void**, unsigned);
  size_t (*free_dctx)(void*);
  size_t (*decompress)(void*, void*, size_t*, const void*, size_t*,
                       const void*);
  unsigned (*is_error)(size_t);
};

const Lz4Api* load_lz4() {
  static const Lz4Api* api = []() -> const Lz4Api* {
    void* lib = dlopen("liblz4.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) lib = dlopen("liblz4.so", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return nullptr;
    static Lz4Api a;
    a.create_dctx = reinterpret_cast<size_t (*)(void**, unsigned)>(
        dlsym(lib, "LZ4F_createDecompressionContext"));
    a.free_dctx = reinterpret_cast<size_t (*)(void*)>(
        dlsym(lib, "LZ4F_freeDecompressionContext"));
    a.decompress = reinterpret_cast<size_t (*)(void*, void*, size_t*,
                                               const void*, size_t*,
                                               const void*)>(
        dlsym(lib, "LZ4F_decompress"));
    a.is_error = reinterpret_cast<unsigned (*)(size_t)>(
        dlsym(lib, "LZ4F_isError"));
    if (!a.create_dctx || !a.free_dctx || !a.decompress || !a.is_error)
      return nullptr;
    return &a;
  }();
  return api;
}

// Decompress one LZ4 frame stream; `hint` pre-sizes the output (the bag
// chunk header's `size` field — may be wrong on hand-rolled bags).
bool lz4_decompress(const std::vector<char>& raw, uint32_t hint,
                    std::vector<char>* out) {
  const Lz4Api* lz4 = load_lz4();
  if (!lz4) return false;
  void* dctx = nullptr;
  if (lz4->is_error(lz4->create_dctx(&dctx, /*LZ4F_VERSION=*/100)))
    return false;
  out->clear();
  std::vector<char> dst(hint > 0 ? hint : (1u << 16));
  size_t src_off = 0;
  bool ok = true;
  while (src_off < raw.size()) {
    size_t dst_sz = dst.size();
    size_t src_sz = raw.size() - src_off;
    size_t rc = lz4->decompress(dctx, dst.data(), &dst_sz,
                                raw.data() + src_off, &src_sz, nullptr);
    if (lz4->is_error(rc) || (dst_sz == 0 && src_sz == 0)) {
      ok = false;
      break;
    }
    out->insert(out->end(), dst.data(), dst.data() + dst_sz);
    src_off += src_sz;
  }
  lz4->free_dctx(dctx);
  return ok;
}

struct RecordInfo {
  std::vector<char> header;  // header bytes (kept from the indexing pass)
  int64_t data_off = 0;      // file offset of the data bytes
  uint32_t dlen = 0;         // on-disk data length
  uint32_t usize = 0;        // uncompressed size (== dlen when none)
  uint8_t op = 0;
  uint8_t comp = 0;          // 0 none, 1 bz2, 2 other/unsupported
};

// sanity bound: no legitimate bag record header approaches this, and an
// unvalidated length from a corrupt file must never become a huge
// allocation (std::bad_alloc cannot cross the C ABI — it would terminate
// the host process instead of letting Python raise)
constexpr uint32_t kMaxHeaderLen = 1u << 20;

struct Bag {
  std::string path;
  std::vector<RecordInfo> records;
  int prefetch_depth = 4;

  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::unordered_map<int64_t, std::vector<char>> cache;  // decompressed data
  std::atomic<int64_t> consumer{0};
  std::atomic<bool> stop{false};
  int64_t next_fetch = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> error{false};

  ~Bag() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  bool fetch_one(int64_t idx, std::vector<char>* out) {
    const RecordInfo& r = records[idx];
    std::vector<char> raw(r.dlen);
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    bool ok = std::fseek(f, static_cast<long>(r.data_off), SEEK_SET) == 0 &&
              std::fread(raw.data(), 1, r.dlen, f) == r.dlen;
    std::fclose(f);
    if (!ok) return false;
    if (r.comp == 0) {
      *out = std::move(raw);
      return true;
    }
    if (r.comp == 1) {
      bz2_decomp_fn bz2 = load_bz2();
      if (!bz2) return false;
      out->resize(r.usize);
      unsigned dst_len = r.usize;
      if (bz2(out->data(), &dst_len, raw.data(), r.dlen, 0, 0) != 0)
        return false;
      out->resize(dst_len);
      return true;
    }
    if (r.comp == 3) return lz4_decompress(raw, r.usize, out);
    return false;  // unsupported compression
  }

  void worker_loop() {
    for (;;) {
      int64_t idx = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          if (stop) return true;
          int64_t lo = consumer.load();
          int64_t hi = std::min<int64_t>(lo + prefetch_depth,
                                         (int64_t)records.size());
          if (next_fetch < lo) next_fetch = lo;
          while (next_fetch < hi &&
                 (records[next_fetch].op != 0x05 ||
                  cache.count(next_fetch))) {
            ++next_fetch;   // only chunk records need prefetching
          }
          return next_fetch < hi;
        });
        if (stop) return;
        idx = next_fetch++;
        cache[idx];  // reserve (empty) so other workers skip it
      }
      std::vector<char> buf;
      if (!fetch_one(idx, &buf)) error = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        cache[idx] = std::move(buf);
      }
      cv_done.notify_all();
    }
  }
};

bool index_bag(Bag* bag) {
  FILE* f = std::fopen(bag->path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const int64_t file_size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char magic[13] = {0};
  if (std::fread(magic, 1, 13, f) != 13 ||
      std::strncmp(magic, "#ROSBAG V2.0", 12) != 0) {
    std::fclose(f);
    return false;
  }
  // records start right after the magic line's newline. Any malformed
  // length / truncated record marks the WHOLE bag invalid (return false):
  // silently indexing a prefix would make corruption look like an empty or
  // short bag; the Python wrapper raises on the failed open.
  bool ok = true;
  for (;;) {
    uint32_t hlen;
    size_t got = std::fread(&hlen, 4, 1, f);
    if (got != 1) break;                       // clean EOF
    RecordInfo rec;
    if (hlen > kMaxHeaderLen ||
        std::ftell(f) + (int64_t)hlen + 4 > file_size) {
      ok = false;
      break;
    }
    rec.header.resize(hlen);
    if (std::fread(rec.header.data(), 1, hlen, f) != hlen) {
      ok = false;
      break;
    }
    uint32_t dlen;
    if (std::fread(&dlen, 4, 1, f) != 1) {
      ok = false;
      break;
    }
    rec.data_off = std::ftell(f);
    if (rec.data_off + (int64_t)dlen > file_size) {
      ok = false;
      break;
    }
    rec.dlen = dlen;
    rec.usize = dlen;
    // parse header fields we need: op, compression, size
    size_t off = 0;
    while (off + 4 <= hlen) {
      uint32_t flen;
      std::memcpy(&flen, rec.header.data() + off, 4);
      off += 4;
      if (off + flen > hlen) break;
      const char* item = rec.header.data() + off;
      const char* eq = static_cast<const char*>(memchr(item, '=', flen));
      if (eq) {
        std::string name(item, eq - item);
        const char* val = eq + 1;
        size_t vlen = flen - (name.size() + 1);
        if (name == "op" && vlen >= 1) {
          rec.op = static_cast<uint8_t>(val[0]);
        } else if (name == "compression") {
          std::string c(val, vlen);
          rec.comp = (c == "none") ? 0
                     : (c == "bz2") ? 1
                     : (c == "lz4") ? 3
                                    : 2;
        } else if (name == "size" && vlen >= 4) {
          std::memcpy(&rec.usize, val, 4);
        }
      }
      off += flen;
    }
    const int64_t next_off = rec.data_off + dlen;  // before the move below
    bag->records.push_back(std::move(rec));
    if (std::fseek(f, static_cast<long>(next_off), SEEK_SET) != 0) {
      ok = false;
      break;
    }
  }
  std::fclose(f);
  return ok;
}

std::mutex g_mu;
std::unordered_map<int64_t, Bag*> g_bags;
int64_t g_next = 1;

Bag* get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_bags.find(h);
  return it == g_bags.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

int64_t bag_open(const char* path, int prefetch_depth, int n_workers) try {
  Bag* bag = new Bag();
  bag->path = path;
  bag->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 4;
  if (!index_bag(bag)) {
    delete bag;
    return 0;
  }
  int nw = n_workers > 0 ? n_workers : 2;
  for (int i = 0; i < nw; ++i)
    bag->workers.emplace_back([bag] { bag->worker_loop(); });
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_bags[h] = bag;
  return h;
} catch (...) {
  return 0;  // exceptions must not cross the C ABI (ctypes would terminate)
}

int64_t bag_record_count(int64_t h) {
  Bag* bag = get(h);
  return bag ? static_cast<int64_t>(bag->records.size()) : -1;
}

// op and DECOMPRESSED payload size (0 on bad index). comp_ok = 0 for
// unsupported compression (the caller takes the Python path).
int bag_record_info(int64_t h, int64_t i, int* op, int64_t* size,
                    int* comp_ok) {
  Bag* bag = get(h);
  if (!bag || i < 0 || i >= (int64_t)bag->records.size()) return 0;
  const RecordInfo& r = bag->records[i];
  *op = r.op;
  *size = r.usize;
  *comp_ok = (r.comp == 2)                  ? 0
             : (r.comp == 1 && !load_bz2()) ? 0
             : (r.comp == 3 && !load_lz4()) ? 0
                                            : 1;
  return 1;
}

int64_t bag_read_header(int64_t h, int64_t i, char* buf, int64_t cap) {
  Bag* bag = get(h);
  if (!bag || i < 0 || i >= (int64_t)bag->records.size()) return -1;
  const RecordInfo& r = bag->records[i];  // kept in memory since indexing
  if (cap < (int64_t)r.header.size()) return -1;
  std::memcpy(buf, r.header.data(), r.header.size());
  return static_cast<int64_t>(r.header.size());
}

// Blocks until record i's (decompressed) payload is available; serves
// non-chunk records synchronously and chunks from the prefetch cache.
int64_t bag_read_data(int64_t h, int64_t i, char* buf, int64_t cap) {
  Bag* bag = get(h);
  if (!bag || i < 0 || i >= (int64_t)bag->records.size()) return -1;
  const RecordInfo& r = bag->records[i];
  if (r.op != 0x05) {
    std::vector<char> out;
    if (!bag->fetch_one(i, &out) || (int64_t)out.size() > cap) return -1;
    std::memcpy(buf, out.data(), out.size());
    return static_cast<int64_t>(out.size());
  }
  // store consumer under the lock: a worker evaluating its cv_work.wait
  // predicate with the stale consumer value could otherwise miss this
  // notify and sleep forever (lost wakeup), deadlocking the reader
  std::unique_lock<std::mutex> lk(bag->mu);
  bag->consumer.store(i);
  bag->cv_work.notify_all();
  bag->cv_done.wait(lk, [&] {
    auto it = bag->cache.find(i);
    return bag->error.load() ||
           (it != bag->cache.end() && !it->second.empty()) ||
           (it != bag->cache.end() && r.usize == 0);
  });
  auto it = bag->cache.find(i);
  if (it == bag->cache.end() || (it->second.empty() && r.usize != 0))
    return -1;
  if ((int64_t)it->second.size() > cap) return -1;
  std::memcpy(buf, it->second.data(), it->second.size());
  int64_t n = static_cast<int64_t>(it->second.size());
  // drop everything at or before i — the reader is sequential
  for (auto iter = bag->cache.begin(); iter != bag->cache.end();) {
    if (iter->first <= i) iter = bag->cache.erase(iter);
    else ++iter;
  }
  bag->consumer.store(i + 1);
  lk.unlock();
  bag->cv_work.notify_all();
  return n;
}

void bag_close(int64_t h) {
  Bag* bag = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_bags.find(h);
    if (it != g_bags.end()) {
      bag = it->second;
      g_bags.erase(it);
    }
  }
  delete bag;
}

}  // extern "C"
