// The damped Gauss-Newton step of the VGICP loops (registration/vgicp.py,
// through ops/gn_step.py), one launch for a batch of frames: for each frame
//
//     xi = -(H + lm I)^-1 g         (6x6 Schur complement, adjugate 3x3 inverses)
//     xi = 0 where non-finite       (no correspondences) or the frame is inactive
//     T <- exp(xi) T,  dlt = sum |xi|
//
// It replaces no TPU kernel: the JAX package computes this step in plain jnp
// (the `gn_update` closures of icp4dradar_tpu/registration/vgicp.py, lines
// 98-102 and 201-205), which XLA fuses into a few ops. In eager PyTorch the
// same step is ~200 small launches and a synchronizing constant copy
// (se3_from_rt's bottom row) per GN iteration; the host, not the card, paces
// it. Bound on an H100: launch latency. A frame reads T (16 floats), H (36),
// g (6) and an active byte, and writes T (16) and dlt (1): ~300 bytes and
// ~670 FP32 operations (utils/roofline.py::gn_step_bound), so 128 frames are
// ~38 KB, ~0.01 us at 3.35 TB/s. Design (gn_step_kernel): one thread a frame, 128
// threads a block, a grid of ceil(n / 128) blocks; every value stays in
// registers, nothing is shared between threads, so a frame's result depends
// on its own inputs alone (the same bits at every batch size).
//
// The operations and their order are the plain path's on the card
// (`ops/gn_step.py::gn_step_plain`, ATen's elementwise kernels): each
// product, sum and quotient rounded once (the build's -fmad=false keeps
// products and sums apart), a division by a constant c taken as a product
// with fl(1/c) as ATen takes a division by a Python scalar, and each small
// product's sum over k in the order torch.sum runs it (ATen's Reduce.cuh).
// That order follows the product tensor's memory layout: where k is its
// innermost axis, lane l of last_pow2(k) lanes sums terms l, l + lanes, ...
// and the lanes are added at halving offsets, so 3 terms give (x0 + x2) + x1
// and 6 give ((x0 + x4) + x2) + ((x1 + x5) + x3) (sum_lanes); where ATen
// laid k out beside an output axis, one thread sums in order (sum_seq).
// sinf, cosf and sqrtf are CUDA's, as ATen's torch.sin, torch.cos and
// torch.sqrt are. On an H100 with torch 2.11 the kernel gives the plain
// path's bits (tests/test_torch_gpu.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// torch.sum's accumulators start at 0 (0 + x turns -0 into +0).
__device__ __forceinline__ float sum_seq3(float x0, float x1, float x2) {
  return add(add(add(0.0f, x0), x1), x2);
}
__device__ __forceinline__ float sum_seq4(float x0, float x1, float x2, float x3) {
  return add(add(add(add(0.0f, x0), x1), x2), x3);
}
__device__ __forceinline__ float sum_lanes3(float x0, float x1, float x2) {
  return add(add(add(0.0f, x0), x2), x1);
}
__device__ __forceinline__ float sum_lanes6(const float x[6]) {
  return add(add(add(add(0.0f, x[0]), x[4]), add(0.0f, x[2])),
             add(add(add(0.0f, x[1]), x[5]), add(0.0f, x[3])));
}

// geom/linalg.py::inv3x3: the adjugate over the determinant; singular -> 0.
__device__ void inv3x3(const float m[3][3], float out[3][3]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float c00 = sub(mul(e, i), mul(f, h));
  const float c01 = -sub(mul(d, i), mul(f, g));
  const float c02 = sub(mul(d, h), mul(e, g));
  const float c10 = -sub(mul(b, i), mul(c, h));
  const float c11 = sub(mul(a, i), mul(c, g));
  const float c12 = -sub(mul(a, h), mul(b, g));
  const float c20 = sub(mul(b, f), mul(c, e));
  const float c21 = -sub(mul(a, f), mul(c, d));
  const float c22 = sub(mul(a, e), mul(b, d));
  const float det = add(add(mul(a, c00), mul(b, c01)), mul(c, c02));
  const float inv_det = fabsf(det) > 1e-30f ? quo(1.0f, det) : 0.0f;
  const float adj_t[3][3] = {{c00, c10, c20}, {c01, c11, c21}, {c02, c12, c22}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[r][k] = mul(adj_t[r][k], inv_det);
  }
}

// geom/linalg.py::solve_spd6 on b = -g: x2 from the Schur complement
// S = C - B^T A^-1 B, then x1.
__device__ void solve_spd6(const float hd[6][6], const float b[6], float x[6]) {
  float A[3][3], B[3][3], C[3][3], Ainv[3][3], BtAinv[3][3], S[3][3], Sinv[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      A[r][k] = hd[r][k];
      B[r][k] = hd[r][3 + k];
      C[r][k] = hd[3 + r][3 + k];
    }
  }
  inv3x3(A, Ainv);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      BtAinv[r][k] = sum_seq3(mul(B[0][r], Ainv[0][k]), mul(B[1][r], Ainv[1][k]),
                              mul(B[2][r], Ainv[2][k]));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      S[r][k] = sub(C[r][k], sum_seq3(mul(BtAinv[r][0], B[0][k]), mul(BtAinv[r][1], B[1][k]),
                                      mul(BtAinv[r][2], B[2][k])));
    }
  }
  inv3x3(S, Sinv);
  float r2[3], r1[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    r2[r] = sub(b[3 + r], sum_lanes3(mul(BtAinv[r][0], b[0]), mul(BtAinv[r][1], b[1]),
                                     mul(BtAinv[r][2], b[2])));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    x[3 + r] = sum_lanes3(mul(Sinv[r][0], r2[0]), mul(Sinv[r][1], r2[1]), mul(Sinv[r][2], r2[2]));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    r1[r] = sub(b[r], sum_lanes3(mul(B[r][0], x[3]), mul(B[r][1], x[4]), mul(B[r][2], x[5])));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    x[r] = sum_lanes3(mul(Ainv[r][0], r1[0]), mul(Ainv[r][1], r1[1]), mul(Ainv[r][2], r1[2]));
  }
}

// geom/se3.py::se3_exp (with so3_exp's rotation): twist [v, w] -> E (4x4),
// the Taylor window theta^2 < 1e-8.
__device__ void se3_exp(const float xi[6], float E[4][4]) {
  const float v[3] = {xi[0], xi[1], xi[2]};
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float theta2 = sum_lanes3(mul(w[0], w[0]), mul(w[1], w[1]), mul(w[2], w[2]));
  const bool small = theta2 < 1e-8f;
  const float theta = __fsqrt_rn(small ? 1.0f : theta2);
  const float s = sinf(theta), c = cosf(theta);
  const float a = small ? sub(1.0f, mul(theta2, 1.0f / 6.0f)) : quo(s, theta);
  const float b = small ? sub(0.5f, mul(theta2, 1.0f / 24.0f)) : quo(sub(1.0f, c), theta2);
  const float cc = small ? sub((float)(1.0 / 6.0), mul(theta2, 1.0f / 120.0f))
                         : quo(sub(theta, s), mul(theta2, theta));
  const float K[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float KK[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      KK[r][k] = sum_seq3(mul(K[r][0], K[0][k]), mul(K[r][1], K[1][k]), mul(K[r][2], K[2][k]));
    }
  }
  float V[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float eye = r == k ? 1.0f : 0.0f;
      E[r][k] = add(add(eye, mul(a, K[r][k])), mul(b, KK[r][k]));
      V[r][k] = add(add(eye, mul(b, K[r][k])), mul(cc, KK[r][k]));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    E[r][3] = sum_lanes3(mul(V[r][0], v[0]), mul(V[r][1], v[1]), mul(V[r][2], v[2]));
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
}

__global__ void __launch_bounds__(kThreads)
gn_step_kernel(const float* __restrict__ T, long long t_row, const float* __restrict__ H,
               long long h_row, const float* __restrict__ g, long long g_row,
               const unsigned char* __restrict__ active, float lm, int n,
               float* __restrict__ T_out, float* __restrict__ dlt) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= n) return;
  const float* Hf = H + f * h_row;
  const float* gf = g + f * g_row;
  const float* Tf = T + f * t_row;
  float hd[6][6], b[6], xi[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int k = 0; k < 6; ++k) hd[r][k] = add(Hf[6 * r + k], mul(lm, r == k ? 1.0f : 0.0f));
    b[r] = -gf[r];
  }
  solve_spd6(hd, b, xi);
  const bool hold = active != nullptr && active[f] == 0;
  float absxi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (!isfinite(xi[k]) || hold) xi[k] = 0.0f;
    absxi[k] = fabsf(xi[k]);
  }
  float E[4][4], Tin[4][4];
  se3_exp(xi, E);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) Tin[r][k] = Tf[4 * r + k];
  }
  float* To = T_out + 16 * (long long)f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      To[4 * r + k] = sum_seq4(mul(E[r][0], Tin[0][k]), mul(E[r][1], Tin[1][k]),
                               mul(E[r][2], Tin[2][k]), mul(E[r][3], Tin[3][k]));
    }
  }
  dlt[f] = sum_lanes6(absxi);
}

}  // namespace

// T (n, 4, 4), H (n, 6, 6), g (n, 6) float32, each row-major within a frame
// and `*_row` floats from one frame to the next (read only: rows may
// overlap); active (n,) bytes or null (every frame active). Writes T_out
// (n, 4, 4) contiguous and dlt (n,).
extern "C" int gn_step_launch(const float* T, long long t_row, const float* H, long long h_row,
                              const float* g, long long g_row, const unsigned char* active,
                              float lm, int n, float* T_out, float* dlt, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  gn_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      T, t_row, H, h_row, g, g_row, active, lm, n, T_out, dlt);
  return (int)cudaGetLastError();
}
