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
// What bounds it on an H100: FP32 instruction slots. A (source, target)
// pair is 9 separately rounded ops (3 sub, 3 mul, 3 add: no FMA
// contraction), each a whole slot; at the bench size one ICP iteration is
// up to 1024 pairs x 2048 x 2048 = 4.3e9 point pairs, ~1.16 ms at 9 slots a
// pair on 132 SMs.
//
// Design (every choice cuts instruction slots per pair or pairs swept):
// - Operands packed once per registration by the wrapper (ops/icp_fused.py):
//   sources (B, N, 4) [x, y, z, mask] and targets (B, M, 4) [x, y, z,
//   penalty], each pair's live rows first in row order, with live counts.
//   Masked sources add nothing (every moment carries the mask), and a masked
//   target (d2 >= 1e30) never beats a live one, so a pair sweeps only its
//   live targets with its live sources; a pair with no live target sweeps
//   all M rows at the penalty, which keeps the all-masked result (dmin =
//   fl(1e30 + ...), q the mean of every row).
// - Four sources per thread, 128 threads, 512 sources per block, grid
//   (ceil(N / 512), B): one broadcast float4 load from shared memory feeds
//   four independent d2 chains.
// - The tie state leaves the inner loop: per source and chunk of 64 targets
//   only a running chunk minimum (one FMNMX a pair, 10 slots in all). After
//   each chunk the source keeps (best, first chunk holding it, tie flag: a
//   later chunk reached the same minimum). After the sweep each source
//   re-scans its first chunk for the first row at the minimum, and a
//   flagged source (or one with two such rows there) re-scans on to the end,
//   summing every row at the minimum in row order, as the plain version
//   adds ties. d2 is recomputed by the same ops, so it has the same bits.
// - Targets staged into shared memory with cp.async (16-byte rows), 2048
//   rows (32 KB) a tile; a pair's live cloud at the bench size is one tile,
//   still resident for the re-scan (beyond it the re-scan reads L2).
// - `active` (B,) bytes, read on the device: an inactive (converged) pair's
//   blocks write zero rows and exit, as do blocks past a pair's live
//   sources.
//
// Numerics: p and d2 are evaluated in the Pallas kernel's order with
// round-to-nearest intrinsics (the file is also built with -fmad=false), so
// exact-f32 ties split the same way as in the plain PyTorch version. The
// per-point products are f32, as in the TPU kernel; their sums run in
// double, as in the plain version, so the two agree to the last f32 bits
// rather than to the order of a long f32 sum. Live targets are assumed
// within ~1e15 m (d2 below the 1e30 penalty), as the plain version's
// penalty rule also assumes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSrcPerThread = 4;
constexpr int kSrcPerBlock = kThreads * kSrcPerThread;
constexpr int kTile = 2048;
constexpr int kChunk = 64;
constexpr int kMoments = 19;
static_assert(kTile % kChunk == 0, "tiles hold whole chunks");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d2 = ((pen + dx^2) + dy^2) + dz^2, each op rounded, as the Pallas kernel.
__device__ __forceinline__ float pair_d2(const float4 t, float px, float py, float pz) {
  const float dx = __fsub_rn(t.x, px);
  const float dy = __fsub_rn(t.y, py);
  const float dz = __fsub_rn(t.z, pz);
  return __fadd_rn(__fadd_rn(__fadd_rn(t.w, __fmul_rn(dx, dx)), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
icp_moments_kernel(const float* __restrict__ T,              // (B, 4, 4)
                   const float4* __restrict__ src,           // (B, N) [xyz, mask]
                   const int* __restrict__ src_live,         // (B,)
                   const float4* __restrict__ tgt,           // (B, M) [xyz, pen]
                   const int* __restrict__ tgt_live,         // (B,)
                   const unsigned char* __restrict__ active,  // (B,) or null
                   double* __restrict__ out,                 // (B, nblk, 19)
                   int N, int M, float gate) {
  __shared__ __align__(16) float4 tile[kTile];
  __shared__ double red[kWarps][kMoments];

  const int b = blockIdx.y;
  const int first = blockIdx.x * kSrcPerBlock;
  const int ns = src_live[b];
  double* orow = out + ((size_t)b * gridDim.x + blockIdx.x) * kMoments;
  if ((active != nullptr && active[b] == 0) || first >= ns) {
    if (threadIdx.x < kMoments) orow[threadIdx.x] = 0.0;
    return;  // uniform over the block: no barrier is left waiting
  }
  const int nl = tgt_live[b];
  const int R = nl > 0 ? nl : M;  // rows swept
  const float4* tg = tgt + (size_t)b * M;

  // this thread's sources: first + threadIdx.x * 4 + k, live below ns
  const int i0 = first + threadIdx.x * kSrcPerThread;
  const float* Tb = T + (size_t)b * 16;
  float px[kSrcPerThread], py[kSrcPerThread], pz[kSrcPerThread], sw[kSrcPerThread];
#pragma unroll
  for (int k = 0; k < kSrcPerThread; ++k) {
    const int i = i0 + k;
    const float4 s = i < ns ? src[(size_t)b * N + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    sw[k] = s.w;
    // p = R s + t, summed left to right as the Pallas kernel does
    float p[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      p[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(Tb[4 * r + 0], s.x),
                                           __fmul_rn(Tb[4 * r + 1], s.y)),
                                 __fmul_rn(Tb[4 * r + 2], s.z)),
                       Tb[4 * r + 3]);
    }
    px[k] = p[0];
    py[k] = p[1];
    pz[k] = p[2];
  }
  const bool any = i0 < ns;

  float best[kSrcPerThread];
  int fchunk[kSrcPerThread];
  unsigned tie = 0u;  // bit k: a later chunk reached source k's minimum
#pragma unroll
  for (int k = 0; k < kSrcPerThread; ++k) {
    best[k] = INFINITY;
    fchunk[k] = 0;
  }
  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int r = threadIdx.x; r < n; r += kThreads) cp_async16(&tile[r], tg + base + r);
    cp_async_wait_all();
    __syncthreads();
    if (!any) continue;
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int c1 = min(n, c0 + kChunk);
      float cm[kSrcPerThread];
#pragma unroll
      for (int k = 0; k < kSrcPerThread; ++k) cm[k] = INFINITY;
#pragma unroll 8
      for (int r = c0; r < c1; ++r) {
        const float4 t = tile[r];
#pragma unroll
        for (int k = 0; k < kSrcPerThread; ++k) {
          cm[k] = fminf(cm[k], pair_d2(t, px[k], py[k], pz[k]));
        }
      }
      const int chunk = (base + c0) / kChunk;
#pragma unroll
      for (int k = 0; k < kSrcPerThread; ++k) {
        if (cm[k] < best[k]) {
          best[k] = cm[k];
          fchunk[k] = chunk;
          tie &= ~(1u << k);
        } else if (cm[k] == best[k]) {
          tie |= 1u << k;
        }
      }
    }
  }

  // the whole swept cloud is still in shared memory when it fit one tile
  const bool resident = R <= kTile;
  double m[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) m[k] = 0.0;
  // unrolled, so the per-source arrays stay in registers
#pragma unroll
  for (int k = 0; k < kSrcPerThread; ++k) {
    if (i0 + k >= ns) continue;
    // first row at the minimum: in the first chunk that reached it
    const int c0 = fchunk[k] * kChunk, c1 = min(R, c0 + kChunk);
    int j0 = R, eq = 0;
    for (int j = c0; j < c1; ++j) {
      const float4 t = resident ? tile[j] : __ldg(&tg[j]);
      if (pair_d2(t, px[k], py[k], pz[k]) == best[k]) {
        j0 = j0 < R ? j0 : j;
        ++eq;
      }
    }
    float qx = 0.f, qy = 0.f, qz = 0.f, cnt = 0.f;
    if (j0 < R) {
      const float4 t0 = resident ? tile[j0] : __ldg(&tg[j0]);
      qx = t0.x;
      qy = t0.y;
      qz = t0.z;
      cnt = 1.f;
      if (eq > 1 || ((tie >> k) & 1u)) {  // exact tie: average in row order
        for (int j = j0 + 1; j < R; ++j) {
          const float4 t = resident ? tile[j] : __ldg(&tg[j]);
          if (pair_d2(t, px[k], py[k], pz[k]) == best[k]) {
            qx = __fadd_rn(qx, t.x);
            qy = __fadd_rn(qy, t.y);
            qz = __fadd_rn(qz, t.z);
            cnt = __fadd_rn(cnt, 1.f);
          }
        }
      }
    }
    const float c = fmaxf(cnt, 1.f);
    const float q[3] = {__fdiv_rn(qx, c), __fdiv_rn(qy, c), __fdiv_rn(qz, c)};
    const float p[3] = {px[k], py[k], pz[k]};
    const float w = __fmul_rn(sw[k], best[k] < gate ? 1.f : 0.f);
    float wp[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) wp[a] = __fmul_rn(w, p[a]);
    m[0] += w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      m[1 + a] += wp[a];
      m[4 + a] += __fmul_rn(w, q[a]);
#pragma unroll
      for (int c2 = 0; c2 < 3; ++c2) m[7 + 3 * a + c2] += __fmul_rn(wp[a], q[c2]);
    }
    m[16] += __fmul_rn(w, best[k]);
    m[17] += __fmul_rn(sw[k], best[k]);
    m[18] += sw[k];
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
    orow[threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int icp_moments_sources_per_block() { return kSrcPerBlock; }

// Launches on `stream`; returns cudaGetLastError() (0 on success). src and
// tgt are the packed (B, N, 4) / (B, M, 4) operands with their (B,) live
// counts; active is a (B,) byte mask or null (every pair). B must fit
// grid.y (<= 65535); the caller splits larger batches.
extern "C" int icp_moments_launch(const float* T, const float* src, const int* src_live,
                                  const float* tgt, const int* tgt_live,
                                  const unsigned char* active, double* out, int B, int N,
                                  int M, float gate, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kSrcPerBlock - 1) / kSrcPerBlock, B);
  icp_moments_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      T, reinterpret_cast<const float4*>(src), src_live,
      reinterpret_cast<const float4*>(tgt), tgt_live, active, out, N, M, gate);
  return (int)cudaGetLastError();
}
