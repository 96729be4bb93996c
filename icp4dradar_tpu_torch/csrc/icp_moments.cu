// Fused ICP iteration moments for NVIDIA Hopper (sm_90a).
//
// Replaces icp4dradar_tpu/ops/icp_fused.py::_make_icp_moments_kernel (the
// Pallas TPU kernel behind icp_iteration_moments). For each frame pair b and
// each source point i it computes
//
//   p   = R_b s_i + t_b
//   d2  = pen_j + |t_j - p|^2 for every target j (pen_j = 1e30 if masked)
//   dmin, and q = the mean of every target with d2 == dmin (tie average)
//   w   = mask_i * (dmin < gate)
//
// and reduces the 19 moments
//   [sw, swp(3), swq(3), swpq(9), sw*dmin, s(mask*dmin), s(mask)]
// over the block's sources into one float64 row of out (B, nblk, 19); the
// caller sums the rows (one torch.sum over blocks, deterministic, no
// atomics) and rounds the moments to f32 once.
//
// What bounds it on an H100: FP32 ALU throughput. Every (source, target)
// pair costs ~8 flops (3 sub, 3 mul, 3 add) plus a compare; at the bench
// size one ICP iteration is 1024 pairs x 2048 x 2048 = 4.3e9 point pairs.
// Read from shared memory, each pair is one broadcast 16-byte load.
//
// Design: one source point per thread, 256 threads per block, grid
// (ceil(N/256), B). The pair's targets are staged through shared memory in
// tiles of 1024 x (x, y, z, penalty) = 16 KB; each thread keeps its running
// best d2 and the tie sum / count in registers, so no (targets x sources)
// tile ever exists. The TPU kernel's ones column and (TM, 5) layout fed its
// matrix unit and are not needed here.
//
// Numerics: p and d2 are evaluated in the Pallas kernel's order with
// round-to-nearest intrinsics (no FMA contraction; the file is also built
// with -fmad=false), so exact-f32 ties split the same way as in the plain
// PyTorch version. The per-point products are f32, as in the TPU kernel;
// their sums run in double, as in the plain version, so the two agree to
// the last f32 bits rather than to the order of a long f32 sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;
constexpr int kMoments = 19;
constexpr float kMaskPenalty = 1e30f;

__global__ void __launch_bounds__(kThreads)
icp_moments_kernel(const float* __restrict__ T,         // (B, 4, 4)
                   const float* __restrict__ src,       // (B, N, 3)
                   const float* __restrict__ src_mask,  // (B, N)
                   const float* __restrict__ tgt,       // (B, M, 3)
                   const float* __restrict__ tgt_mask,  // (B, M)
                   double* __restrict__ out,            // (B, nblk, 19)
                   int N, int M, float gate) {
  __shared__ float4 tile[kTile];
  __shared__ double red[kWarps][kMoments];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < N;

  const float* Tb = T + (size_t)b * 16;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, sw = 0.f;
  if (live) {
    const float* s = src + ((size_t)b * N + i) * 3;
    s0 = s[0];
    s1 = s[1];
    s2 = s[2];
    sw = src_mask[(size_t)b * N + i];
  }
  // p = R s + t, summed left to right as the Pallas kernel does
  float p[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(Tb[4 * r + 0], s0),
                                         __fmul_rn(Tb[4 * r + 1], s1)),
                               __fmul_rn(Tb[4 * r + 2], s2)),
                     Tb[4 * r + 3]);
  }

  float best = INFINITY;
  float qx = 0.f, qy = 0.f, qz = 0.f, cnt = 0.f;
  const float* tg = tgt + (size_t)b * M * 3;
  const float* tm = tgt_mask + (size_t)b * M;
  for (int base = 0; base < M; base += kTile) {
    const int n = min(kTile, M - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* t = tg + (size_t)(base + j) * 3;
      tile[j] = make_float4(t[0], t[1], t[2],
                            tm[base + j] > 0.5f ? 0.f : kMaskPenalty);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float4 t = tile[j];
        const float dx = __fsub_rn(t.x, p[0]);
        const float dy = __fsub_rn(t.y, p[1]);
        const float dz = __fsub_rn(t.z, p[2]);
        const float d2 = __fadd_rn(
            __fadd_rn(__fadd_rn(t.w, __fmul_rn(dx, dx)), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d2 < best) {
          best = d2;
          qx = t.x;
          qy = t.y;
          qz = t.z;
          cnt = 1.f;
        } else if (d2 == best) {  // exact tie: average the payloads
          qx = __fadd_rn(qx, t.x);
          qy = __fadd_rn(qy, t.y);
          qz = __fadd_rn(qz, t.z);
          cnt = __fadd_rn(cnt, 1.f);
        }
      }
    }
  }

  double m[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) m[k] = 0.0;
  if (live) {
    const float c = fmaxf(cnt, 1.f);
    const float q[3] = {__fdiv_rn(qx, c), __fdiv_rn(qy, c), __fdiv_rn(qz, c)};
    const float w = __fmul_rn(sw, best < gate ? 1.f : 0.f);
    float wp[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) wp[a] = __fmul_rn(w, p[a]);
    m[0] = w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      m[1 + a] = wp[a];
      m[4 + a] = __fmul_rn(w, q[a]);
#pragma unroll
      for (int c2 = 0; c2 < 3; ++c2) m[7 + 3 * a + c2] = __fmul_rn(wp[a], q[c2]);
    }
    m[16] = __fmul_rn(w, best);
    m[17] = __fmul_rn(sw, best);
    m[18] = sw;
  }

  // block reduction: warp shuffles, then a fixed-order sum over warps
#pragma unroll
  for (int k = 0; k < kMoments; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m[k] += __shfl_down_sync(0xffffffffu, m[k], off);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) red[warp][k] = m[k];
  }
  __syncthreads();
  if (threadIdx.x < kMoments) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[((size_t)b * gridDim.x + blockIdx.x) * kMoments + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int icp_moments_threads() { return kThreads; }

// Launches on `stream`; returns cudaGetLastError() (0 on success). B must
// fit grid.y (<= 65535); the caller splits larger batches.
extern "C" int icp_moments_launch(const float* T, const float* src,
                                  const float* src_mask, const float* tgt,
                                  const float* tgt_mask, double* out, int B,
                                  int N, int M, float gate, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  icp_moments_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      T, src, src_mask, tgt, tgt_mask, out, N, M, gate);
  return (int)cudaGetLastError();
}
