// Arena-wide fused AdamA optimizer kernels for Hopper (sm_90a).
//
// arena_fold  replaces repro/kernels/fused_step.py::arena_fold (the Pallas
//             kernel _fold_body, fp32 m/v codecs, fp32 gradient wire,
//             unguarded, static scale):
//               gs = g*s
//               m  = dm*m + (1-b1)*gs        m, v updated in place
//               v  = dv*v + (1-b2)*gs^2
//             The first fold of a mini-batch passes (dm, dv) = (b1, b2),
//             which fuses the begin-minibatch decay into it; later folds
//             pass (1, 1).
// arena_fold_slice replaces repro/kernels/fused_step.py::arena_fold_slice
//             (_slice_fold_body, same form): the arena_fold arithmetic on
//             arena rows [off, off + rows_g) only, g being a (rows_g, 1024)
//             slab; no other row is read or written. Algorithm 2 launches
//             it once per layer and once for the rest region.
// arena_apply replaces repro/kernels/fused_step.py::arena_apply (_apply_body,
//             fp32/fp32, no master params, unguarded):
//               p = p - lr*(m/bc1 / (sqrt(v/bc2) + eps) + wd*p)   in place
//
// Both are pure streaming elementwise passes over (rows, 1024) fp32 arenas,
// bound by device-memory bandwidth: the fold reads m, v, g and writes m, v
// (5 x 4 B per element), the apply reads p, m, v and writes p (4 x 4 B).
// At the bert-large arena (357,888 x 1024 = 366,477,312 elements, 1.466 GB
// per operand) that is 7.33 GB for the fold, >= 2.19 ms, and 5.86 GB for
// the apply, >= 1.75 ms, at the data sheet's 3.35 TB/s. The slice fold
// moves the same 20 B per element of its slab: 253 MB (>= 0.0755 ms) for a
// bert-large layer of 12,352 rows, 1.25 GB (>= 0.374 ms) for the rest
// region of 61,248 rows. Each arithmetic
// step is a handful of fp32 operations per 20 B moved, far below the
// card's fp32 rate, so the design only has to keep HBM busy: every thread
// moves 16 B per operand per iteration (float4 loads and stores,
// neighbouring threads on neighbouring addresses) in a grid-stride loop
// over a grid sized to a few waves of the SMs.
//
// Rounding. The reference's CPU lowering (XLA) evaluates
//   dm*m + c1*gs        as fma(dm, m, c1*gs)
//   dv*v + c2*gs*gs     as fma(dv, v, c2*(gs*gs))
//   (m/bc1)/(sqrt+eps)  as m / (bc1*(sqrt(v/bc2) + eps))
//   u + wd*p            as fma(wd, p, u)
//   p - lr*u            as fma(-lr, u, p)
// The kernels spell out exactly these operations (explicit fmaf) and are
// compiled with --fmad=false so that nvcc contracts nothing else; division
// and sqrtf are IEEE-rounded (no --use_fast_math). The plain PyTorch
// versions in fused_step.py compute the same expressions, so kernel, plain
// version and reference agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kLanes = 1024;       // arena row width
constexpr int kWavesPerSm = 8;

__device__ __forceinline__ void fold1(float& m, float& v, float g, float s,
                                      float c1, float c2, float dm, float dv) {
  const float gs = g * s;
  m = fmaf(dm, m, c1 * gs);
  v = fmaf(dv, v, c2 * (gs * gs));
}

__global__ void __launch_bounds__(kThreads)
arena_fold_kernel(float4* __restrict__ m, float4* __restrict__ v,
                  const float4* __restrict__ g, int64_t n4, float s,
                  float c1, float c2, float dm, float dv) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gg = g[i];
    float4 mm = m[i];
    float4 vv = v[i];
    fold1(mm.x, vv.x, gg.x, s, c1, c2, dm, dv);
    fold1(mm.y, vv.y, gg.y, s, c1, c2, dm, dv);
    fold1(mm.z, vv.z, gg.z, s, c1, c2, dm, dv);
    fold1(mm.w, vv.w, gg.w, s, c1, c2, dm, dv);
    m[i] = mm;
    v[i] = vv;
  }
}

// The slab's row r folds into arena row off + r: m and v are the whole
// arenas, offset here, so one kernel serves every layer.
__global__ void __launch_bounds__(kThreads)
arena_fold_slice_kernel(float4* __restrict__ m, float4* __restrict__ v,
                        const float4* __restrict__ g, int64_t off4,
                        int64_t n4, float s, float c1, float c2, float dm,
                        float dv) {
  m += off4;
  v += off4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 gg = g[i];
    float4 mm = m[i];
    float4 vv = v[i];
    fold1(mm.x, vv.x, gg.x, s, c1, c2, dm, dv);
    fold1(mm.y, vv.y, gg.y, s, c1, c2, dm, dv);
    fold1(mm.z, vv.z, gg.z, s, c1, c2, dm, dv);
    fold1(mm.w, vv.w, gg.w, s, c1, c2, dm, dv);
    m[i] = mm;
    v[i] = vv;
  }
}

__device__ __forceinline__ float apply1(float p, float m, float v, float lr,
                                        float bc1, float bc2, float eps,
                                        float wd) {
  float u = m / (bc1 * (sqrtf(v / bc2) + eps));
  if (wd != 0.0f) u = fmaf(wd, p, u);
  return fmaf(-lr, u, p);
}

__global__ void __launch_bounds__(kThreads)
arena_apply_kernel(float4* __restrict__ p, const float4* __restrict__ m,
                   const float4* __restrict__ v, int64_t n4, float lr,
                   float bc1, float bc2, float eps, float wd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 mm = m[i];
    const float4 vv = v[i];
    float4 pp = p[i];
    pp.x = apply1(pp.x, mm.x, vv.x, lr, bc1, bc2, eps, wd);
    pp.y = apply1(pp.y, mm.y, vv.y, lr, bc1, bc2, eps, wd);
    pp.z = apply1(pp.z, mm.z, vv.z, lr, bc1, bc2, eps, wd);
    pp.w = apply1(pp.w, mm.w, vv.w, lr, bc1, bc2, eps, wd);
    p[i] = pp;
  }
}

int grid_for(int64_t n4) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n4 + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kWavesPerSm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes). `n` is the
// element count, a multiple of 4; every pointer is 16-byte aligned (the
// Python wrappers check both). Each returns cudaGetLastError() after the
// launch, so a refused launch surfaces as a non-zero code.
extern "C" int arena_fold_launch(void* m, void* v, const void* g, int64_t n,
                                 float s, float c1, float c2, float dm,
                                 float dv, void* stream) {
  const int64_t n4 = n / 4;
  arena_fold_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (float4*)m, (float4*)v, (const float4*)g, n4, s, c1, c2, dm, dv);
  return (int)cudaGetLastError();
}

// m, v: the whole arenas; g: the (rows_g, 1024) slab for arena rows
// [row_offset, row_offset + rows_g), inside the arena (checked by the
// wrapper).
extern "C" int arena_fold_slice_launch(void* m, void* v, const void* g,
                                       int64_t row_offset, int64_t rows_g,
                                       float s, float c1, float c2, float dm,
                                       float dv, void* stream) {
  const int64_t n4 = rows_g * (kLanes / 4);
  arena_fold_slice_kernel<<<grid_for(n4), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (float4*)m, (float4*)v, (const float4*)g, row_offset * (kLanes / 4),
      n4, s, c1, c2, dm, dv);
  return (int)cudaGetLastError();
}

extern "C" int arena_apply_launch(void* p, const void* m, const void* v,
                                  int64_t n, float lr, float bc1, float bc2,
                                  float eps, float wd, void* stream) {
  const int64_t n4 = n / 4;
  arena_apply_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (float4*)p, (const float4*)m, (const float4*)v, n4, lr, bc1, bc2, eps,
      wd);
  return (int)cudaGetLastError();
}
