// Fused VGICP Gauss-Newton sweep for NVIDIA Hopper (sm_90a).
//
// Replaces icp4dradar_tpu/ops/vgicp_fused.py::_make_vgicp_kernel (the
// Pallas TPU kernel behind vgicp_iteration and vgicp_iteration_batch). For
// each frame b of the launch and each source point i it computes
//
//   p   = R_b s_i + t_b
//   d2  = pen_j + (x_j - p_x)^2 + (y_j - p_y)^2 + (z_j - p_z)^2 for every
//         submap row j of the live target tiles (pen = 1e30 if masked)
//   the matched payload [mean3, cov6]: per tile, the mean of every row at
//         exactly the tile's minimum; across tiles a later tile replaces the
//         running best only if its minimum is STRICTLY smaller
//   w   = mask_i * (best d2 < gate)
//   M   = (R Ca R^T + Cb + eps I)^-1 (closed-form adjugate, |det| >= 1e-20)
//   the 30 Mahalanobis GN terms: packed upper H (21), g (6), cost, w, w d2
//
// and reduces the terms over the block's sources into one float64 row of
// out (B, nblk, 30) (no float atomics; the caller sums the rows). When
// `best` is given it also writes the matched payload [d2, mean3, cov6] in
// the Pallas kernel's (ns, 10, ts) layout for a later frozen GN step.
//
// What bounds it on an H100: per (source, target) pair 9 FP32 operations
// and a compare. At the bench block (8 frames x 2048 sources against one
// ~800-row live tile) that is ~1.3e7 pairs, ~1.2e8 flops: ~2 us at the 67
// TFLOP/s FP32 peak. Latency, not throughput, bounds it there: a launch is a
// few us, and a simple design (one thread per source walking ~800
// dependent rows, one block per SM) leaves every scheduler idle most
// cycles.
//
// Design (vgicp_sweep_kernel): a block holds 64 sources of one frame, two
// per lane, and 8 warps; each warp sweeps the block's 64 sources against
// its own contiguous range of the tile's rows, so the bench block is 256
// blocks of 8 warps: one wave at two resident blocks (16 warps) per SM.
// In the loop a source keeps only a running minimum over chunks of 32 rows
// (one FMNMX a pair, no payload and no tie state); after each chunk the
// range keeps (min, first chunk at it, tie flag: a later chunk reached the
// same min). The 8 ranges merge in shared memory in row order (a strictly
// smaller minimum replaces, an equal one flags a tie), which keeps the
// in-tile tie rule: warps 0 and 1 (one source per lane) then re-scan the
// chunk that first reached the minimum for its first row, gather that
// row's payload [mean3, cov6] and, for a tie only, re-scan the rest of the
// tile summing every row at the minimum in row order (d2 recomputed by the
// same ops, so with the same bits), and finish with the GN epilogue.
// Operands come packed once per registration (ops/vgicp_fused.py): targets
// (P, 4) [mean, penalty] with each tile's live rows first in row order and
// a per-tile live count, covariances (P, 8) in the same order. Serving
// (B-stream batches) stacks S such target sets, one per stream, and a
// launch's frames are S runs of consecutive frames, one per stream: a
// block reads its frame's set (the JAX package's vmapped pallas_call gives
// its kernel a batch grid axis with one target set per stream). The stream
// changes only the base a block reads from, not how it sweeps. A tile with
// a live row sweeps only those (a masked row's d2 >= 1e30 never beats one);
// a tile without sweeps all its rows at the penalty, as the Pallas kernel.
// The tile is staged with cp.async in 16-byte rows. The live count is read
// on the device (no host sync) and tiles past it are never loaded: the
// dead-tile skip of the Pallas kernel. Across tiles a later tile replaces
// the running best only if strictly smaller.
//
// Numerics: p, d2 and the GN terms are evaluated in the Pallas kernel's
// order, each product and sum rounded separately (the library is built
// with -fmad=false), so the selections and per-point terms agree with the
// plain PyTorch version to the last bit; only the order of the float64 sums
// differs.
//
// The second entry point, vgicp_frozen_launch, replaces
// icp4dradar_tpu/ops/vgicp_fused.py::_make_vgicp_frozen_kernel (behind
// vgicp_iteration_frozen, the inner GN steps of gicp.inner_gn_steps > 0):
// the same 30 sums re-linearised at a new T on the payload a sweep matched,
// gated on the fresh |q - p|^2. It lives in this file to share gn_terms.
// Bound on an H100: bytes, not operations. Per source it reads 10 floats of
// source and 10 of payload (80 B) and does ~300 FP32 operations; 2048
// sources are 164 KB, ~0.05 us at 3.35 TB/s, so a launch (a few us) bounds
// it, and the host work around the launch bounds the call. Design
// (vgicp_frozen_kernel): one launch finishes the step. Each group of
// frames (`_acc_groups`) is one thread block cluster of 8 blocks x 256
// threads (one source a thread at one 2048-point frame; a thread loops over
// a larger group's sources). Each thread sums its sources' 30 terms in
// float64; the sums run in a fixed order (warp shuffles, the block's warps
// in order, then rank 0 adds the 8 ranks' sums in rank order through
// distributed shared memory), so two launches on the same inputs give the
// same bits, with no atomics. Rank 0 casts to float32 and writes the
// group's finished row of 45: H unpacked (36), g (6), cost, sum w, sum w d2.
// It reads the sources the sweep reads, packed once per registration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFrozenWarps = 8;  // the frozen pass: 8 x 256 threads a group
constexpr int kFrozenThreads = kFrozenWarps * 32;
constexpr int kFrozenCluster = 8;
constexpr int kOut = 45;  // H (36), g (6), cost, sum w, sum w d2
constexpr int kSweepWarps = 8;  // the sweep: 64 sources x 8 row ranges
constexpr int kSweepThreads = kSweepWarps * 32;
constexpr int kSweepSources = 64;  // two per lane
constexpr int kChunk = 32;  // rows per running minimum in a warp's range
constexpr int kMaxTile = 1024;
constexpr int kAcc = 30;
constexpr int kSrcCols = 10;  // x, y, z, mask, cov6
constexpr int kCovCols = 8;   // cov6, two zeros (32-byte rows)
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

// The 30 GN terms of one source point (vgicp_fused.py:194-261, same order).
__device__ void gn_terms(const float R[3][3], const float p[3], float w_src,
                         const float ca[6], const float q[3], const float cb[6],
                         float d2, float gate, float eps, float* acc) {
  const float Cf[3][3] = {{ca[0], ca[3], ca[4]},
                          {ca[3], ca[1], ca[5]},
                          {ca[4], ca[5], ca[2]}};
  float D[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      D[r][c] = sum3(__fmul_rn(R[r][0], Cf[0][c]), __fmul_rn(R[r][1], Cf[1][c]),
                     __fmul_rn(R[r][2], Cf[2][c]));
    }
  }
  const int ia[6] = {0, 1, 2, 0, 0, 1};
  const int ic[6] = {0, 1, 2, 1, 2, 2};
  float cs[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float cp = sum3(__fmul_rn(D[ia[k]][0], R[ic[k]][0]),
                          __fmul_rn(D[ia[k]][1], R[ic[k]][1]),
                          __fmul_rn(D[ia[k]][2], R[ic[k]][2]));
    cs[k] = __fadd_rn(cp, cb[k]);
  }
  const float w = __fmul_rn(w_src, d2 < gate ? 1.f : 0.f);

  // _sym_inv3: closed-form inverse of the packed symmetric sum + eps I
  const float a = __fadd_rn(cs[0], eps), b = __fadd_rn(cs[1], eps),
              c = __fadd_rn(cs[2], eps);
  const float d = cs[3], e = cs[4], f = cs[5];
  const float cA = __fsub_rn(__fmul_rn(b, c), __fmul_rn(f, f));
  const float cB = __fsub_rn(__fmul_rn(a, c), __fmul_rn(e, e));
  const float cC = __fsub_rn(__fmul_rn(a, b), __fmul_rn(d, d));
  const float cD = -__fsub_rn(__fmul_rn(d, c), __fmul_rn(f, e));
  const float cE = __fsub_rn(__fmul_rn(d, f), __fmul_rn(b, e));
  const float cF = -__fsub_rn(__fmul_rn(a, f), __fmul_rn(d, e));
  const float det = sum3(__fmul_rn(a, cA), __fmul_rn(d, cD), __fmul_rn(e, cE));
  const float sgn = det > 0.f ? 1.f : (det < 0.f ? -1.f : (det == det ? 0.f : det));
  const float inv_det = __fmul_rn(__fdiv_rn(1.f, fmaxf(fabsf(det), 1e-20f)), sgn);
  const float m00 = __fmul_rn(cA, inv_det), m11 = __fmul_rn(cB, inv_det),
              m22 = __fmul_rn(cC, inv_det), m01 = __fmul_rn(cD, inv_det),
              m02 = __fmul_rn(cE, inv_det), m12 = __fmul_rn(cF, inv_det);
  const float Mf[3][3] = {{m00, m01, m02}, {m01, m11, m12}, {m02, m12, m22}};

  float r_[3], Mr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) r_[k] = __fsub_rn(q[k], p[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Mr[k] = sum3(__fmul_rn(Mf[k][0], r_[0]), __fmul_rn(Mf[k][1], r_[1]),
                 __fmul_rn(Mf[k][2], r_[2]));
  }
  const float pxMr[3] = {
      __fsub_rn(__fmul_rn(p[1], Mr[2]), __fmul_rn(p[2], Mr[1])),
      __fsub_rn(__fmul_rn(p[2], Mr[0]), __fmul_rn(p[0], Mr[2])),
      __fsub_rn(__fmul_rn(p[0], Mr[1]), __fmul_rn(p[1], Mr[0]))};
  const float hp[3][3] = {{0.f, -p[2], p[1]}, {p[2], 0.f, -p[0]}, {-p[1], p[0], 0.f}};
  float Mhp[3][3], Hww[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c2 = 0; c2 < 3; ++c2) {
      Mhp[r][c2] = sum3(__fmul_rn(Mf[r][0], hp[0][c2]), __fmul_rn(Mf[r][1], hp[1][c2]),
                        __fmul_rn(Mf[r][2], hp[2][c2]));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c2 = 0; c2 < 3; ++c2) {
      Hww[r][c2] = sum3(__fmul_rn(hp[0][r], Mhp[0][c2]), __fmul_rn(hp[1][r], Mhp[1][c2]),
                        __fmul_rn(hp[2][r], Mhp[2][c2]));
    }
  }
  int k = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c2 = r; c2 < 3; ++c2) acc[k++] = __fmul_rn(w, Mf[r][c2]);
#pragma unroll
    for (int c2 = 0; c2 < 3; ++c2) acc[k++] = __fmul_rn(w, -Mhp[r][c2]);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c2 = r; c2 < 3; ++c2) acc[k++] = __fmul_rn(w, Hww[r][c2]);
  }
  // k == 21
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[21 + j] = __fmul_rn(w, -Mr[j]);
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[24 + j] = __fmul_rn(w, -pxMr[j]);
  const float cost = sum3(__fmul_rn(r_[0], Mr[0]), __fmul_rn(r_[1], Mr[1]),
                          __fmul_rn(r_[2], Mr[2]));
  acc[27] = __fmul_rn(w, cost);
  acc[28] = w;
  acc[29] = __fmul_rn(w, d2);
}

// T_b of the launch's frame b: R (3x3) and t (3).
__device__ void load_transform(const float* Tb, float R[3][3], float t[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[r][c] = Tb[4 * r + c];
    t[r] = Tb[4 * r + 3];
  }
}

// p = R s + t, summed left to right as the Pallas kernels do.
__device__ void transform_point(const float R[3][3], const float t[3], const float s[3],
                                float p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = __fadd_rn(sum3(__fmul_rn(R[r][0], s[0]), __fmul_rn(R[r][1], s[1]),
                          __fmul_rn(R[r][2], s[2])),
                     t[r]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d2 = ((pen + dx^2) + dy^2) + dz^2, each op rounded, as the Pallas kernel.
__device__ __forceinline__ float pair_d2(const float4 m, const float p[3]) {
  const float dx = __fsub_rn(m.x, p[0]);
  const float dy = __fsub_rn(m.y, p[1]);
  const float dz = __fsub_rn(m.z, p[2]);
  return __fadd_rn(__fadd_rn(__fadd_rn(m.w, __fmul_rn(dx, dx)), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// After a chunk of a range: a strictly smaller chunk minimum becomes the
// range's (with its chunk), an equal one flags a tie.
__device__ __forceinline__ void close_chunk(float cm, int chunk, float& m, int& fc, bool& tie) {
  if (cm < m) {
    m = cm;
    fc = chunk;
    tie = false;
  } else if (cm == m) {
    tie = true;
  }
}

__global__ void __launch_bounds__(kSweepThreads, 2)
vgicp_sweep_kernel(const float* __restrict__ T,          // (B, 4, 4)
                   const float* __restrict__ src,        // (B * N, 10)
                   const float4* __restrict__ tgt,       // (S * P,) [mean, penalty]
                   const float* __restrict__ tgt_cov,    // (S * P, 8)
                   const int* __restrict__ tile_live,    // (S, ceil(P / tm))
                   const int* __restrict__ tgt_count,    // (S,) live rows
                   int N, int src_offset, int frame0, int stream_frames, int P, int tm,
                   int ts, float gate, float eps,
                   double* __restrict__ out,             // (B, nblk, 30)
                   float* __restrict__ best_out) {       // (ns, 10, ts) or null
  __shared__ __align__(16) float4 s_mean[kMaxTile];
  __shared__ float s_min[kSweepWarps][kSweepSources];
  __shared__ int s_chunk[kSweepWarps][kSweepSources];
  __shared__ int s_tie[kSweepWarps][kSweepSources];
  __shared__ double s_red[2][kAcc];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kSweepSources;  // the block's first source

  float R[3][3], t[3];
  load_transform(T + (size_t)b * 16, R, t);
  // the sweep's two sources per lane: i0 + lane and i0 + 32 + lane
  float pa[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + h * 32 + lane;
    float xyz[3] = {0.f, 0.f, 0.f};
    if (i < N) {
#pragma unroll
      for (int k = 0; k < 3; ++k) xyz[k] = src[((size_t)b * N + i) * kSrcCols + k];
    }
    transform_point(R, t, xyz, pa[h]);
  }
  // warps 0 and 1 merge, gather and finish source i0 + warp * 32 + lane
  float pe[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) pe[k] = warp == 0 ? pa[0][k] : pa[1][k];
  const int col = (warp & 1) * 32 + lane;

  // the frame's stream (frames of a stream are consecutive) and its
  // target set: rows, covariances, per-tile live counts and live count
  const int stream = (frame0 + b) / stream_frames;
  const int nt = (P + tm - 1) / tm;
  tgt += (size_t)stream * P;
  tgt_cov += (size_t)stream * P * kCovCols;
  tile_live += (size_t)stream * nt;
  // live tiles: tile 0 always, then every tile that starts below the count
  const int cnt = tgt_count[stream];
  const int nt_live = cnt <= 0 ? 1 : min(nt, (cnt + tm - 1) / tm);

  float best_d2 = kBig;  // warps 0 and 1 carry the sweep's best
  float bp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) bp[k] = 0.f;
  for (int j = 0; j < nt_live; ++j) {
    const int base = j * tm;
    const int lj = tile_live[j];
    const int n = lj > 0 ? lj : min(tm, P - base);  // rows swept
    __syncthreads();  // warps 0 and 1 are done with the previous tile
    for (int r = threadIdx.x; r < n; r += kSweepThreads) cp_async16(&s_mean[r], tgt + base + r);
    cp_async_wait_all();
    __syncthreads();
    // this warp's contiguous row range, for both of the lane's sources, in
    // chunks of 32 rows: a running chunk minimum (one FMNMX a pair), then
    // the range's (min, first chunk at it, tie flag)
    const int per = (n + kSweepWarps - 1) / kSweepWarps;
    const int r0 = min(n, warp * per), r1 = min(n, r0 + per);
    float m0 = INFINITY, m1 = INFINITY;
    int c0 = 0, c1 = 0;
    bool t0 = false, t1 = false;
    for (int q = r0; q < r1; q += kChunk) {
      const int qe = min(r1, q + kChunk);
      float cm0 = INFINITY, cm1 = INFINITY;
#pragma unroll 4
      for (int r = q; r < qe; ++r) {
        const float4 mr = s_mean[r];
        cm0 = fminf(cm0, pair_d2(mr, pa[0]));
        cm1 = fminf(cm1, pair_d2(mr, pa[1]));
      }
      close_chunk(cm0, (q - r0) / kChunk, m0, c0, t0);
      close_chunk(cm1, (q - r0) / kChunk, m1, c1, t1);
    }
    s_min[warp][lane] = m0;
    s_chunk[warp][lane] = c0;
    s_tie[warp][lane] = t0;
    s_min[warp][32 + lane] = m1;
    s_chunk[warp][32 + lane] = c1;
    s_tie[warp][32 + lane] = t1;
    __syncthreads();
    if (warp >= 2) continue;
    // merge the ranges in row order: the tile's min, the first (range,
    // chunk) at it, and whether another chunk reached it
    float tmin = s_min[0][col];
    int tw = 0, tc = s_chunk[0][col];
    bool ttie = s_tie[0][col] != 0;
#pragma unroll
    for (int w = 1; w < kSweepWarps; ++w) {
      const float mw = s_min[w][col];
      if (mw < tmin) {
        tmin = mw;
        tw = w;
        tc = s_chunk[w][col];
        ttie = s_tie[w][col] != 0;
      } else if (mw == tmin) {
        ttie = true;
      }
    }
    if (tmin < best_d2) {  // across tiles: strictly smaller only
      // the first row at the minimum, in the chunk that first reached it
      const int q = min(n, tw * per) + tc * kChunk;
      const int qe = min(min(n, min(n, tw * per) + per), q + kChunk);
      int tfirst = n, eq = 0;
      for (int r = q; r < qe; ++r) {
        if (pair_d2(s_mean[r], pe) == tmin) {
          tfirst = tfirst < n ? tfirst : r;
          ++eq;
        }
      }
      const float4 mf = s_mean[tfirst];
      const float* cf = tgt_cov + (size_t)(base + tfirst) * kCovCols;
      float sum[9] = {mf.x, mf.y, mf.z, cf[0], cf[1], cf[2], cf[3], cf[4], cf[5]};
      float c = 1.f;
      if (ttie || eq > 1) {  // exact tie inside the tile: average in row order
        for (int r = tfirst + 1; r < n; ++r) {
          const float4 mr = s_mean[r];
          if (pair_d2(mr, pe) == tmin) {
            const float* cr = tgt_cov + (size_t)(base + r) * kCovCols;
            c = __fadd_rn(c, 1.f);
            sum[0] = __fadd_rn(sum[0], mr.x);
            sum[1] = __fadd_rn(sum[1], mr.y);
            sum[2] = __fadd_rn(sum[2], mr.z);
#pragma unroll
            for (int k = 0; k < 6; ++k) sum[3 + k] = __fadd_rn(sum[3 + k], cr[k]);
          }
        }
      }
      best_d2 = tmin;
#pragma unroll
      for (int k = 0; k < 9; ++k) bp[k] = __fdiv_rn(sum[k], c);
    }
  }

  // the GN terms of warps 0 and 1's sources, summed in float64: warp
  // shuffles in a fixed order, then warp 0's sums plus warp 1's
  if (warp < 2) {
    const int i = i0 + col;
    float acc[kAcc];
    if (i < N) {
      const size_t row = (size_t)b * N + i;
      float s[kSrcCols];
#pragma unroll
      for (int k = 0; k < kSrcCols; ++k) s[k] = src[row * kSrcCols + k];
      gn_terms(R, pe, s[3], s + 4, bp, bp + 3, best_d2, gate, eps, acc);
      if (best_out != nullptr) {
        const size_t g = (size_t)src_offset + row;
        const size_t blk = g / ts, ln = g % ts;
        best_out[(blk * 10) * ts + ln] = best_d2;
#pragma unroll
        for (int k = 0; k < 9; ++k) best_out[(blk * 10 + 1 + k) * ts + ln] = bp[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      double v = (double)acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_red[warp][k] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    out[((size_t)b * gridDim.x + blockIdx.x) * kAcc + threadIdx.x] =
        s_red[0][threadIdx.x] + s_red[1][threadIdx.x];
  }
}

// The GN terms re-linearised at T on FROZEN correspondences (K5): no
// search; each source reads the payload [d2, mean3, cov6] that a sweep
// matched it to, in the (ns, 10, ts) layout, and gates on the FRESH
// distance |q - p|^2 (a row whose stale d2 is >= 2.5e29 never matched and
// gets 1e30, above any gate). Group g of the launch is the sources
// g * per_group .. (g + 1) * per_group - 1 (whole frames of N sources); the
// cluster of 8 blocks that covers it writes out[g] = [H (36, row-major), g
// (6), cost, sum w, sum w d2] in float32.
__global__ void __launch_bounds__(kFrozenThreads)
vgicp_frozen_kernel(const float* __restrict__ T,     // (B, 4, 4)
                    const float* __restrict__ src,   // (B * N, 10)
                    const float* __restrict__ best,  // (ns, 10, ts)
                    int per_group, int N, int ts, float gate, float eps,
                    float* __restrict__ out) {       // (groups, 45)
  __shared__ double s_red[kFrozenWarps][kAcc];
  __shared__ double s_blk[kAcc];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)(blockIdx.x / C) * per_group;

  double sum[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) sum[k] = 0.0;
  float R[3][3], t[3];
  int frame = -1;
  for (int j = rank * kFrozenThreads + threadIdx.x; j < per_group;
       j += C * kFrozenThreads) {
    const size_t row = row0 + j;
    const int b = (int)(row / N);
    if (b != frame) {
      load_transform(T + (size_t)b * 16, R, t);
      frame = b;
    }
    float s[kSrcCols], p[3], pay[10], acc[kAcc];
#pragma unroll
    for (int k = 0; k < kSrcCols; ++k) s[k] = src[row * kSrcCols + k];
    transform_point(R, t, s, p);
    const size_t blk = row / ts, ln = row % ts;
#pragma unroll
    for (int k = 0; k < 10; ++k) pay[k] = best[(blk * 10 + k) * ts + ln];
    const float d0 = __fsub_rn(pay[1], p[0]), d1 = __fsub_rn(pay[2], p[1]),
                d2 = __fsub_rn(pay[3], p[2]);
    const float fresh = sum3(__fmul_rn(d0, d0), __fmul_rn(d1, d1), __fmul_rn(d2, d2));
    const float gate_d2 = pay[0] < 2.5e29f ? fresh : kBig;
    gn_terms(R, p, s[3], s + 4, pay + 1, pay + 4, gate_d2, gate, eps, acc);
#pragma unroll
    for (int k = 0; k < kAcc; ++k) sum[k] += (double)acc[k];
  }

  // the block's sums: warp shuffles in a fixed order, then warps in order
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    double v = sum[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < kFrozenWarps; ++w) v += s_red[w][threadIdx.x];
    s_blk[threadIdx.x] = v;
  }
  cluster.sync();  // every rank's sums are in its shared memory
  if (rank == 0 && threadIdx.x < kOut) {
    // output o reads packed sum k: H[r][c] is entry (min, max) of the
    // row-major upper triangle (`_sym6_index`), then g, cost, w, w d2
    const int o = threadIdx.x;
    int k = o - 36 + 21;
    if (o < 36) {
      const int a = min(o / 6, o % 6), c = max(o / 6, o % 6);
      k = a * 6 - a * (a - 1) / 2 + (c - a);
    }
    double v = 0.0;
    for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(s_blk, q)[k];
    out[(size_t)(blockIdx.x / C) * kOut + o] = (float)v;
  }
  cluster.sync();  // rank 0 is done reading the other ranks
}

}  // namespace

extern "C" int vgicp_sweep_sources_per_block() { return kSweepSources; }

// Launches on `stream`; returns cudaGetLastError() (0 on success). B frames
// of N sources each (src rows b*N .. b*N+N-1, global source index
// src_offset + b*N + i for the best layout) against packed target sets of
// P rows each ([mean, penalty], covariances (P, 8), tiles of tm <= 1024 rows
// with their live counts, one live count), one set per stream: frame b of
// this launch is frame frame0 + b of the call and reads the set of stream
// (frame0 + b) / stream_frames (one stream, stream_frames = the call's
// frames: the single-target sweep). B must fit grid.y (<= 65535), the
// caller splits larger batches. out gets the per-block float64 rows.
extern "C" int vgicp_sweep_launch(const float* T, const float* src, const float* tgt,
                                  const float* tgt_cov, const int* tile_live,
                                  const int* tgt_count, int B, int N, int src_offset,
                                  int frame0, int stream_frames, int P, int tm, int ts,
                                  float gate, float eps, double* out, float* best,
                                  void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || P <= 0 || tm <= 0 || tm > kMaxTile ||
      ts <= 0 || frame0 < 0 || stream_frames <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kSweepSources - 1) / kSweepSources, B);
  vgicp_sweep_kernel<<<grid, kSweepThreads, 0, (cudaStream_t)stream>>>(
      T, src, reinterpret_cast<const float4*>(tgt), tgt_cov, tile_live, tgt_count, N,
      src_offset, frame0, stream_frames, P, tm, ts, gate, eps, out, best);
  return (int)cudaGetLastError();
}

// Launches the frozen-payload GN step on `stream`, one thread block cluster
// of 8 blocks per group; returns the launch's error (0 on success). B frames
// of N sources (src rows b*N .. b*N+N-1, T (B, 4, 4)) in `groups` groups of
// B / groups consecutive frames; best is the (ns, 10, ts) payload of the
// sweep that matched these sources; out (groups, 45) gets each group's
// finished float32 results.
extern "C" int vgicp_frozen_launch(const float* T, const float* src, const float* best,
                                   int B, int groups, int N, int ts, float gate, float eps,
                                   float* out, void* stream) {
  if (B <= 0 || groups <= 0 || B % groups || N <= 0 || ts <= 0 ||
      (long long)B * N > INT_MAX || (long long)groups * kFrozenCluster > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * kFrozenCluster, 1, 1);
  cfg.blockDim = dim3(kFrozenThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFrozenCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, vgicp_frozen_kernel, T, src, best,
                                             B / groups * N, N, ts, gate, eps, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
