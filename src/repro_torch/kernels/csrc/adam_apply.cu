// Per-leaf bias-corrected Adam apply for Hopper (sm_90a).
//
// adam_apply replaces repro/kernels/adam_apply.py::adam_apply_2d (the
// Pallas kernel _kernel, fp32 p, m and v), reached through
// kernels/ops.py::adam_apply[_tree]:
//     p -= lr * ((m/bc1) / (sqrt(v/bc2) + eps) + wd*p)        in place
// lr, bc1 and bc2 change every step and are launch arguments, as the
// reference passes them as SMEM scalars.
//
// Like adama_accum.cu it runs on a leaf's own memory, without the
// reference's padding to (R, 1024) rows (elementwise, so no value
// changes): any element count, any 4-byte aligned pointer, float4 accesses
// when p, m and v are all 16-byte aligned and one float otherwise.
//
// Bound: p, m and v read once, p written once, 16 B per element, a handful
// of fp32 operations: device memory bandwidth. At 3.35 TB/s the bert-large
// embedding leaf (31,326,208 elements) takes >= 0.150 ms and a stacked wq
// (24 x 1024 x 1024) >= 0.120 ms.
//
// Rounding. The reference's CPU lowering (XLA) evaluates the update as
//     u = m / (bc1*(sqrt(v/bc2) + eps));  u = fma(wd, p, u) if wd != 0
//     p = fma(-lr, u, p)
// the same operations as arena_apply (fused_step.cu). The kernel spells
// them out (explicit fmaf, --fmad=false, IEEE division and sqrtf) so the
// plain PyTorch version in adam_apply.py and the reference agree with it
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWavesPerSm = 8;

__device__ __forceinline__ float apply1(float p, float m, float v, float lr,
                                        float bc1, float bc2, float eps,
                                        float wd) {
  float u = m / (bc1 * (sqrtf(v / bc2) + eps));
  if (wd != 0.0f) u = fmaf(wd, p, u);
  return fmaf(-lr, u, p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adam_apply_kernel(float* __restrict__ p, const float* __restrict__ m,
                  const float* __restrict__ v, int64_t n, float lr,
                  float bc1, float bc2, float eps, float wd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 mm = m4[i];
      const float4 vv = v4[i];
      float4 pp = p4[i];
      pp.x = apply1(pp.x, mm.x, vv.x, lr, bc1, bc2, eps, wd);
      pp.y = apply1(pp.y, mm.y, vv.y, lr, bc1, bc2, eps, wd);
      pp.z = apply1(pp.z, mm.z, vv.z, lr, bc1, bc2, eps, wd);
      pp.w = apply1(pp.w, mm.w, vv.w, lr, bc1, bc2, eps, wd);
      p4[i] = pp;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    p[i] = apply1(p[i], m[i], v[i], lr, bc1, bc2, eps, wd);
  }
}

int grid_for(int64_t work) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kWavesPerSm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// Plain C interface (bound with ctypes). `n` is the element count of each
// operand; every pointer is 4-byte aligned (fp32 tensors). Returns
// cudaGetLastError() after the launch.
extern "C" int adam_apply_launch(void* p, const void* m, const void* v,
                                 int64_t n, float lr, float bc1, float bc2,
                                 float eps, float wd, void* stream) {
  const bool vec =
      (((uintptr_t)p | (uintptr_t)m | (uintptr_t)v) % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    adam_apply_kernel<true><<<grid_for(n / 4 > 0 ? n / 4 : n), kThreads, 0,
                              st>>>((float*)p, (const float*)m,
                                    (const float*)v, n, lr, bc1, bc2, eps,
                                    wd);
  } else {
    adam_apply_kernel<false><<<grid_for(n), kThreads, 0, st>>>(
        (float*)p, (const float*)m, (const float*)v, n, lr, bc1, bc2, eps,
        wd);
  }
  return (int)cudaGetLastError();
}
