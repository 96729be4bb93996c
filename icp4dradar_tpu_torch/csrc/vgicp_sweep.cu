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
// out (B, nblk, 30); the caller sums each frame's rows (one torch.sum over
// blocks: deterministic, no float atomics) and rounds once to f32. When
// `best` is given it also writes the matched payload [d2, mean3, cov6] in
// the Pallas kernel's (ns, 10, ts) layout for a later frozen GN step.
//
// What bounds it on an H100: per (source, target) pair ~9 FP32 operations
// and a compare, read as one broadcast float4 from shared memory. At the
// bench block (8 frames x 2048 sources against one ~1000-row live tile)
// that is ~1.7e7 pairs, ~1.5e8 flops: ~2 us at the 67 TFLOP/s FP32 peak,
// against a launch latency of several us. So launch latency, not the
// card, bounds it there; the per-source epilogue (~300 flops) is small.
//
// Design: one source point per thread, 128 threads per block, grid
// (ceil(N/128), B): a block holds points of one frame only and reads that
// frame's T. 128 threads (not 256) so that the bench block launches 128
// blocks for the 132 SMs. Target tiles of tm <= 1024 rows are staged in
// shared memory as float4 (mean, penalty) + 6 floats of covariance (40 KB);
// the live count is read on the device (no host sync) and tiles past it are
// never loaded: the dead-tile skip of the Pallas kernel. Each thread keeps
// the tile's running (min, payload sum, count) and the sweep's best in
// registers. The TPU kernel's matrix-unit payload gather (one-hot x [t |
// ones]) becomes a branch taken only on a new minimum or an exact tie.
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
// gated on the fresh |q - p|^2. It lives in this file to share gn_terms and
// the block reduction. Bound on an H100: bytes, not operations. Per source
// it reads 10 floats of source and 10 of payload (80 B) and does ~300
// FP32 operations; 2048 sources are 164 KB, ~0.05 us at 3.35 TB/s, so a
// launch (a few us) bounds it in practice. Design: one thread per source,
// the sweep's grid (N/128, B) and its float64 per-block rows, so per-frame
// groups (`_acc_groups`) sum as after a sweep.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 1024;
constexpr int kAcc = 30;
constexpr int kSrcCols = 10;  // x, y, z, mask, cov6
constexpr int kTgtCols = 10;  // x, y, z, cov6, penalty
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

// Sums acc over the block's threads in float64 (warp shuffles, then a
// fixed-order sum over warps) and writes the 30 sums to out_row.
__device__ void block_sum_store(const float acc[kAcc], double* out_row) {
  __shared__ double red[kWarps][kAcc];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    double v = (double)acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    out_row[threadIdx.x] = v;
  }
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

__global__ void __launch_bounds__(kThreads)
vgicp_sweep_kernel(const float* __restrict__ T,        // (B, 4, 4)
                   const float* __restrict__ src,      // (B * N, 10)
                   const float* __restrict__ tgt,      // (P, 10)
                   const int* __restrict__ tgt_count,  // (1,) live rows
                   int N, int src_offset, int P, int tm, int ts, float gate,
                   float eps, double* __restrict__ out,  // (B, nblk, 30)
                   float* __restrict__ best_out) {       // (ns, 10, ts) or null
  __shared__ float4 s_mean[kMaxTile];      // x, y, z, penalty
  __shared__ float s_cov[kMaxTile * 6];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < N;
  const size_t row = (size_t)b * N + i;

  float R[3][3], t[3];
  load_transform(T + (size_t)b * 16, R, t);
  float s[kSrcCols];
#pragma unroll
  for (int k = 0; k < kSrcCols; ++k) s[k] = live ? src[row * kSrcCols + k] : 0.f;
  float p[3];
  transform_point(R, t, s, p);

  // live tiles: tile 0 always, then every tile that starts below the count
  const int cnt = *tgt_count;
  const int nt = (P + tm - 1) / tm;
  const int nt_live = cnt <= 0 ? 1 : min(nt, (cnt + tm - 1) / tm);

  float best_d2 = kBig;
  float bp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) bp[k] = 0.f;
  for (int j = 0; j < nt_live; ++j) {
    const int base = j * tm;
    const int rows = min(tm, P - base);  // the padding rows of the last
                                         // tile (1e30) could never win
    __syncthreads();  // every thread is done with the previous tile
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const float* tr = tgt + (size_t)(base + r) * kTgtCols;
      s_mean[r] = make_float4(tr[0], tr[1], tr[2], tr[9]);
#pragma unroll
      for (int k = 0; k < 6; ++k) s_cov[r * 6 + k] = tr[3 + k];
    }
    __syncthreads();
    if (live) {
      float tmin = INFINITY, tcnt = 0.f;
      float tsum[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) tsum[k] = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float4 m = s_mean[r];
        const float dx = __fsub_rn(m.x, p[0]);
        const float dy = __fsub_rn(m.y, p[1]);
        const float dz = __fsub_rn(m.z, p[2]);
        const float d2 = __fadd_rn(
            __fadd_rn(__fadd_rn(m.w, __fmul_rn(dx, dx)), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d2 < tmin) {
          tmin = d2;
          tcnt = 1.f;
          tsum[0] = m.x;
          tsum[1] = m.y;
          tsum[2] = m.z;
#pragma unroll
          for (int k = 0; k < 6; ++k) tsum[3 + k] = s_cov[r * 6 + k];
        } else if (d2 == tmin) {  // exact tie inside the tile: average
          tcnt = __fadd_rn(tcnt, 1.f);
          tsum[0] = __fadd_rn(tsum[0], m.x);
          tsum[1] = __fadd_rn(tsum[1], m.y);
          tsum[2] = __fadd_rn(tsum[2], m.z);
#pragma unroll
          for (int k = 0; k < 6; ++k) tsum[3 + k] = __fadd_rn(tsum[3 + k], s_cov[r * 6 + k]);
        }
      }
      if (tmin < best_d2) {  // across tiles: strictly smaller only
        best_d2 = tmin;
        const float c = fmaxf(tcnt, 1.f);
#pragma unroll
        for (int k = 0; k < 9; ++k) bp[k] = __fdiv_rn(tsum[k], c);
      }
    }
  }

  float acc[kAcc];
  if (live) {
    gn_terms(R, p, s[3], s + 4, bp, bp + 3, best_d2, gate, eps, acc);
    if (best_out != nullptr) {
      const size_t g = (size_t)src_offset + row;
      const size_t blk = g / ts, lane = g % ts;
      best_out[(blk * 10) * ts + lane] = best_d2;
#pragma unroll
      for (int k = 0; k < 9; ++k) best_out[(blk * 10 + 1 + k) * ts + lane] = bp[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  }

  block_sum_store(acc, out + ((size_t)b * gridDim.x + blockIdx.x) * kAcc);
}

// The GN terms re-linearised at T on FROZEN correspondences (K5): no
// search; each source reads the payload [d2, mean3, cov6] that a sweep
// matched it to, in the (ns, 10, ts) layout, and gates on the FRESH
// distance |q - p|^2 (a row whose stale d2 is >= 2.5e29 never matched and
// gets 1e30, above any gate).
__global__ void __launch_bounds__(kThreads)
vgicp_frozen_kernel(const float* __restrict__ T,     // (B, 4, 4)
                    const float* __restrict__ src,   // (B * N, 10)
                    const float* __restrict__ best,  // (ns, 10, ts)
                    int N, int src_offset, int ts, float gate, float eps,
                    double* __restrict__ out) {      // (B, nblk, 30)
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = (size_t)b * N + i;
  float acc[kAcc];
  if (i < N) {
    float R[3][3], t[3], s[kSrcCols], p[3], pay[10];
    load_transform(T + (size_t)b * 16, R, t);
#pragma unroll
    for (int k = 0; k < kSrcCols; ++k) s[k] = src[row * kSrcCols + k];
    transform_point(R, t, s, p);
    const size_t g = (size_t)src_offset + row;
    const size_t blk = g / ts, lane = g % ts;
#pragma unroll
    for (int k = 0; k < 10; ++k) pay[k] = best[(blk * 10 + k) * ts + lane];
    const float d0 = __fsub_rn(pay[1], p[0]), d1 = __fsub_rn(pay[2], p[1]),
                d2 = __fsub_rn(pay[3], p[2]);
    const float fresh = sum3(__fmul_rn(d0, d0), __fmul_rn(d1, d1), __fmul_rn(d2, d2));
    const float gate_d2 = pay[0] < 2.5e29f ? fresh : kBig;
    gn_terms(R, p, s[3], s + 4, pay + 1, pay + 4, gate_d2, gate, eps, acc);
  } else {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  }
  block_sum_store(acc, out + ((size_t)b * gridDim.x + blockIdx.x) * kAcc);
}

}  // namespace

extern "C" int vgicp_sweep_threads() { return kThreads; }

// Launches on `stream`; returns cudaGetLastError() (0 on success). B frames
// of N sources each (src rows b*N .. b*N+N-1, global source index
// src_offset + b*N + i for the best layout); B must fit grid.y (<= 65535),
// the caller splits larger batches. tm <= 1024.
extern "C" int vgicp_sweep_launch(const float* T, const float* src,
                                  const float* tgt, const int* tgt_count,
                                  int B, int N, int src_offset, int P, int tm,
                                  int ts, float gate, float eps, double* out,
                                  float* best, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || P <= 0 || tm <= 0 || tm > kMaxTile ||
      ts <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  vgicp_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      T, src, tgt, tgt_count, N, src_offset, P, tm, ts, gate, eps, out, best);
  return (int)cudaGetLastError();
}

// Launches the frozen-payload GN pass on `stream`; returns
// cudaGetLastError(). B frames of N sources as for vgicp_sweep_launch; best
// is the (ns, 10, ts) payload of the sweep that matched these sources.
extern "C" int vgicp_frozen_launch(const float* T, const float* src, const float* best,
                                   int B, int N, int src_offset, int ts, float gate,
                                   float eps, double* out, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || ts <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  vgicp_frozen_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      T, src, best, N, src_offset, ts, gate, eps, out);
  return (int)cudaGetLastError();
}
