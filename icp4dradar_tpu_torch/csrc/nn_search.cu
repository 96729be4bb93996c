// Masked brute-force 1-NN search for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of icp4dradar_tpu/ops/knn.py with one
// kernel, nn_search_kernel, launched by nn_search_launch:
//   _nn_kernel (:75, behind nearest_neighbor_pallas)          -> K2: (index, d2)
//   _nn_coords_kernel (:180, behind nearest_neighbor_coords_pallas)
//                                                             -> K3: (d2, tgt[index])
// For each source point s_i and every target row j it forms
//
//   d2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, pen_j))),  d = t_j - s_i
//
// (pen = 1e30 on a masked row), each fused multiply-add rounded once, as
// XLA evaluates the Pallas body; the nearest row is the smallest index among
// the exact minima, and the reported distance is max(d2, 0). Each output
// is optional: the index (K2), the matched row's coordinates (K3), read from
// the targets as given at the winning original index, so that both forms
// are one launch of the same search.
//
// The search reads targets packed once per registration
// (ops/knn.py::nn_prepare): the rows as float4 (x, y, z, 0), live rows first
// in their original order, each packed row's original index, and the live
// count on the device. A masked row's d2 is >= 1e30, so it can win only
// where no live row gives d2 < 1e30: the search sweeps the live rows alone
// (pen = 0, so fma(dx, dx, 0) is dx * dx rounded once), and a source whose
// best is not < 1e30 (no live row, or live rows at NaN, inf or beyond ~1e15
// m) re-scans all M rows in original order with the penalty: the old
// all-rows result, kept exactly.
//
// What bounds it on an H100: per (source, live row) pair 3 subtractions, 3
// multiply-adds and a compare on one float4; the bytes (N*12 + M*16 in, N*8
// out, or N*16 with the coordinates) are ~0.3 MB. At the kNN-GICP path's shape (2048 sources against a
// 16,384-row sector submap with ~542 live rows) that is 1.1e6 pairs, ~1e7
// FP32 operations: ~0.15 us at the 67 TFLOP/s FP32 peak, far below a
// launch (a few us). Over all 16,384 rows (a fully live submap) the bound
// is ~4.5 us. So latency bounds the path's search: the design spends one
// launch a search, no scratch in device memory, and a short dependent chain
// per thread.
//
// Design (nn_search_kernel): one launch, grid (source blocks, C); the C
// blocks along y form a thread block cluster (runtime cluster dims through
// cudaLaunchKernelEx; the wrapper picks C from M, the row capacity, so a
// small or a large live count needs no host sync). A block holds 128
// sources, four per lane, so that one float4 row load feeds four pairs.
// Rank r of the cluster takes a contiguous 1/C of the live rows (read from
// the device count) and stages them with cp.async in tiles of 2048 rows
// (32 KB): one bulk copy in flight instead of each warp waiting on L2 for
// its rows, row by row (measured: 0.0327 ms against 16,384 live rows when
// read from L2, above the old kernel's 0.021). Each of the 8 warps sweeps a
// contiguous 1/8 of a tile. A lane keeps (best, index) per source with a
// strictly-less update over ascending rows. The warps merge in shared
// memory by (d2, index), the smaller index first among equal d2 (tiles
// interleave the warps' rows), then rank 0 merges the C ranks' results in
// rank order, strictly-less, through distributed shared memory
// (cluster.map_shared_rank): rows ascend with rank, so the smallest index
// among the exact minima wins. Rank 0
// runs the fallback scan where it must, then writes max(d2, 0) and the
// original index orig[best] (K2) or that row's coordinates (K3). There is no
// scratch tensor, no second kernel and no atomic. Two cluster.sync()s: one
// before rank 0 reads the other ranks' shared memory, one before any block
// exits (a block's shared memory must outlive its readers).
//
// Stream axis (S independent target sets, serving: a batch of kNN-GICP
// registrations, as the JAX package vmaps nearest_neighbor_pallas): every
// array leads with S, and the grid's x axis holds ceil(N / 128) source
// blocks a stream, so a block finds its stream from blockIdx.x and every
// block's sources, rows, count and outputs belong to that one stream. A
// stream's result is the single-target search's, bit for bit: the same
// rows in the same order through the same code. One launch serves all S
// streams with no host sync (the cluster size C comes from the per-stream
// row capacity M).
//
// The packing (nn_pack_launch, behind nn_prepare on the card) is one launch
// of one block a stream: a stable partition of the rows, live first, equal
// to the plain version's stable sort. It moves ~0.6 MB at M = 16,384 (~0.2 us of
// bytes); latency bounds it, and one launch replaces the dozen torch
// launches (~0.3 ms of host time) of a sort-based packing. Rows go one a
// thread in tiles of 1024, so loads and stores coalesce (a contiguous run
// of rows a thread measured 0.052 ms: uncoalesced, through one SM's L1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e30f;

// ---- K2: the search on prepared targets

constexpr int kSearchWarps = 8;
constexpr int kSearchThreads = kSearchWarps * 32;
constexpr int kPerLane = 4;                      // sources a lane holds
constexpr int kSearchSources = 32 * kPerLane;    // sources a block holds
constexpr int kMaxCluster = 8;                   // portable cluster size
constexpr int kSearchTile = 2048;                // rows staged per pass: 32 KB

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kSearchThreads)
nn_search_kernel(const float* __restrict__ src,    // (S, N, 3)
                 const float4* __restrict__ rows,  // (S, M) [x, y, z, 0], live rows first
                 const int* __restrict__ orig,     // (S, M) original index of each row
                 const int* __restrict__ count,    // (S,) live rows
                 const float* __restrict__ tgt,    // (S, M, 3) as given (fallback, K3)
                 const float* __restrict__ mask,   // (S, M) as given (fallback)
                 int N, int M, int blocks_per_stream,
                 float* __restrict__ d2_out,       // (S, N)
                 int* __restrict__ idx_out,        // (S, N) or null
                 float* __restrict__ q_out) {      // (S, N, 3) or null
  __shared__ __align__(16) float4 s_rows[kSearchTile];
  __shared__ float s_wd[kSearchWarps][kSearchSources];
  __shared__ int s_wi[kSearchWarps][kSearchSources];
  __shared__ float s_rd[kSearchSources];
  __shared__ int s_ri[kSearchSources];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this block's stream: every pointer below is that stream's slice
  const int s = blockIdx.x / blocks_per_stream;
  const int i0 = (blockIdx.x - s * blocks_per_stream) * kSearchSources;
  src += 3 * (size_t)s * N;
  rows += (size_t)s * M;
  orig += (size_t)s * M;
  count += s;
  tgt += 3 * (size_t)s * M;
  mask += (size_t)s * M;
  d2_out += (size_t)s * N;
  if (idx_out != nullptr) idx_out += (size_t)s * N;
  if (q_out != nullptr) q_out += 3 * (size_t)s * N;

  // the lane's sources i0 + h * 32 + lane
  float sx[kPerLane], sy[kPerLane], sz[kPerLane];
#pragma unroll
  for (int h = 0; h < kPerLane; ++h) {
    const int i = i0 + h * 32 + lane;
    const bool on = i < N;
    sx[h] = on ? src[3 * (size_t)i] : 0.f;
    sy[h] = on ? src[3 * (size_t)i + 1] : 0.f;
    sz[h] = on ? src[3 * (size_t)i + 2] : 0.f;
  }

  // this rank's contiguous share of the live rows, staged in tiles; each
  // warp sweeps a contiguous 1/8 of a tile
  const int cnt = min(max(*count, 0), M);
  const int per_rank = (cnt + C - 1) / C;
  const int ra = min(cnt, rank * per_rank);
  const int rb = min(cnt, ra + per_rank);

  float best[kPerLane];
  int bi[kPerLane];
#pragma unroll
  for (int h = 0; h < kPerLane; ++h) {
    best[h] = INFINITY;
    bi[h] = INT_MAX;
  }
  for (int base = ra; base < rb; base += kSearchTile) {
    const int n = min(kSearchTile, rb - base);
    __syncthreads();  // every warp is done with the previous tile
    for (int r = threadIdx.x; r < n; r += kSearchThreads) cp_async16(&s_rows[r], rows + base + r);
    cp_async_wait_all();
    __syncthreads();
    const int per_warp = (n + kSearchWarps - 1) / kSearchWarps;
    const int r0 = min(n, warp * per_warp), r1 = min(n, r0 + per_warp);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float4 t = s_rows[r];
#pragma unroll
      for (int h = 0; h < kPerLane; ++h) {
        const float dx = __fsub_rn(t.x, sx[h]);
        const float dy = __fsub_rn(t.y, sy[h]);
        const float dz = __fsub_rn(t.z, sz[h]);
        const float d = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
        if (d < best[h]) {  // ascending rows, strictly less: smallest index wins
          best[h] = d;
          bi[h] = base + r;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kPerLane; ++h) {
    s_wd[warp][h * 32 + lane] = best[h];
    s_wi[warp][h * 32 + lane] = bi[h];
  }
  __syncthreads();
  const int t = threadIdx.x;  // threads 0..127 merge source i0 + t
  if (t < kSearchSources) {
    float d = s_wd[0][t];
    int ix = s_wi[0][t];
#pragma unroll
    for (int w = 1; w < kSearchWarps; ++w) {  // tiles interleave the warps' rows
      const float dw = s_wd[w][t];
      const int iw = s_wi[w][t];
      if (dw < d || (dw == d && iw < ix)) {
        d = dw;
        ix = iw;
      }
    }
    s_rd[t] = d;
    s_ri[t] = ix;
  }
  cluster.sync();  // every rank's result is in its shared memory
  if (rank == 0 && t < kSearchSources) {
    float d = s_rd[t];
    int ix = s_ri[t];
    for (int q = 1; q < C; ++q) {  // ranks ascend in rows
      const float dq = cluster.map_shared_rank(s_rd, q)[t];
      if (dq < d) {
        d = dq;
        ix = cluster.map_shared_rank(s_ri, q)[t];
      }
    }
    const int i = i0 + t;
    if (i < N) {
      int out_i;
      if (d < kBig) {
        out_i = orig[ix];
      } else {
        // no live row below 1e30: every row in original order, with the
        // penalty, as the all-rows search
        const float px = src[3 * (size_t)i], py = src[3 * (size_t)i + 1],
                    pz = src[3 * (size_t)i + 2];
        d = INFINITY;
        out_i = 0;
        for (int j = 0; j < M; ++j) {
          const float dx = __fsub_rn(__ldg(tgt + 3 * (size_t)j), px);
          const float dy = __fsub_rn(__ldg(tgt + 3 * (size_t)j + 1), py);
          const float dz = __fsub_rn(__ldg(tgt + 3 * (size_t)j + 2), pz);
          const float pen = __ldg(mask + j) > 0.5f ? 0.f : kBig;
          const float dj = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, pen)));
          if (dj < d) {
            d = dj;
            out_i = j;
          }
        }
      }
      d2_out[i] = fmaxf(d, 0.f);
      if (idx_out != nullptr) idx_out[i] = out_i;
      if (q_out != nullptr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) q_out[3 * (size_t)i + k] = tgt[3 * (size_t)out_i + k];
      }
    }
  }
  cluster.sync();  // rank 0 is done reading the other ranks
}

// ---- K2's operands: the targets packed once per registration

constexpr int kPackThreads = 1024;

// rows (M,) [x, y, z, 0] with the live rows (mask > 0.5) first and the
// masked rows after them, both in original order; orig (M,) each packed
// row's original index; count (1,) the live rows; block s packs stream s,
// every array offset by its stream. One block a stream: a first pass
// counts the live rows; a second walks the rows in tiles of 1024, one row
// a thread (coalesced), and places each row by a block-wide scan of the
// tile's live flags (warp ballots, then the warps' counts in order): a
// stable partition, as the plain version's stable sort.
__global__ void __launch_bounds__(kPackThreads)
nn_pack_kernel(const float* __restrict__ tgt,   // (S, M, 3)
               const float* __restrict__ mask,  // (S, M)
               int M,
               float4* __restrict__ rows,       // (S, M)
               int* __restrict__ orig,          // (S, M)
               int* __restrict__ count) {       // (S,)
  constexpr int kPackWarps = kPackThreads / 32;
  const size_t s = blockIdx.x;
  tgt += 3 * s * M;
  mask += s * M;
  rows += s * M;
  orig += s * M;
  count += s;
  __shared__ int s_warp[kPackWarps];
  __shared__ int s_total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int live = 0;
  for (int j = t; j < M; j += kPackThreads) live += __ldg(mask + j) > 0.5f;
  live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) s_warp[warp] = live;
  __syncthreads();
  if (warp == 0) {
    const int v = __reduce_add_sync(0xffffffffu, s_warp[lane]);
    if (lane == 0) s_total = v;
  }
  int placed = 0;  // live rows of the earlier tiles
  for (int base = 0; base < M; base += kPackThreads) {
    const int j = base + t;
    const bool on = j < M;
    const bool f = on && __ldg(mask + j) > 0.5f;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    __syncthreads();  // every thread is done with the previous tile's counts
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int before = 0, tile_live = 0;
#pragma unroll
    for (int w = 0; w < kPackWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      tile_live += c;
    }
    if (on) {
      const int p = placed + before + __popc(bal & ((1u << lane) - 1));  // live rows before j
      const int dst = f ? p : s_total + (j - p);  // masked rows before j: j - p
      rows[dst] = make_float4(__ldg(tgt + 3 * (size_t)j), __ldg(tgt + 3 * (size_t)j + 1),
                              __ldg(tgt + 3 * (size_t)j + 2), 0.f);
      orig[dst] = j;
    }
    placed += tile_live;
  }
  if (t == 0) *count = s_total;
}

}  // namespace

// K2 and K3 on prepared targets for S streams: one launch on `stream` of
// grid (S * ceil(N / 128), cluster), the `cluster` blocks along y one
// thread block cluster (1 to 8). src (S, N, 3); rows (S, M, 4) / orig (S,
// M) / count (S,) as ops/knn.py::nn_prepare packs them, tgt (S, M, 3) and
// mask (S, M) as given. Writes d2 (S, N), and idx (S, N) and q (S, N, 3)
// where they are not null (at least one of them). Returns the launch's
// error (0 on success).
extern "C" int nn_search_launch(const float* src, const float* rows, const int* orig,
                                const int* count, const float* tgt, const float* mask,
                                int S, int N, int M, int cluster, float* d2, int* idx,
                                float* q, void* stream) {
  if (S <= 0 || N <= 0 || M <= 0 || cluster < 1 || cluster > kMaxCluster || d2 == nullptr ||
      (idx == nullptr && q == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks_per_stream = (N + kSearchSources - 1) / kSearchSources;
  if ((long long)S * blocks_per_stream > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * blocks_per_stream, cluster, 1);
  cfg.blockDim = dim3(kSearchThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nn_search_kernel, src,
                                             reinterpret_cast<const float4*>(rows), orig,
                                             count, tgt, mask, N, M, blocks_per_stream, d2,
                                             idx, q);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K2's packing on `stream`, one block a stream: tgt (S, M, 3) and mask (S,
// M) -> rows (S, M, 4), orig (S, M), count (S,) as nn_search_launch reads
// them. Returns the launch's error (0 on success).
extern "C" int nn_pack_launch(const float* tgt, const float* mask, int S, int M,
                              float* rows, int* orig, int* count, void* stream) {
  if (S <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  nn_pack_kernel<<<S, kPackThreads, 0, (cudaStream_t)stream>>>(
      tgt, mask, M, reinterpret_cast<float4*>(rows), orig, count);
  return (int)cudaGetLastError();
}
