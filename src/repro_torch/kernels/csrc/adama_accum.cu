// Per-leaf AdamA fold for Hopper (sm_90a).
//
// adama_accum replaces repro/kernels/adama_accum.py::adama_accum_2d (the
// Pallas kernel _kernel, fp32 m, v and g), reached through
// kernels/ops.py::adama_accumulate[_tree]:
//     m += (1-b1)*s*g        v += (1-b2)*(s*g)^2        in place
// The decay of the per-leaf state form is a separate pass
// (adama.begin_minibatch), as in the reference.
//
// It runs on one leaf, or one layer's view of a stacked leaf, without the
// reference's padding to (R, 1024) rows (kernels/ops.py::_to_2d): the
// update is elementwise, so padding changes no value, and the port folds
// the leaf's own memory in place. So any element count and any 4-byte
// aligned pointer is taken: when m, v and g are all 16-byte aligned each
// thread moves 16 B per operand per iteration (float4) and the last n % 4
// elements are done one by one; otherwise every access is one float.
//
// Bound: m, v and g read once, m and v written once, 20 B per element, a
// handful of fp32 operations: device memory bandwidth. At 3.35 TB/s the
// bert-large embedding leaf (31,326,208 elements) takes >= 0.187 ms and
// one layer's wq (1,048,576) >= 6.3 us, where launch overhead dominates.
//
// Rounding. The reference's CPU lowering (XLA) folds (1-b1)*s into one
// float32 constant and contracts the first moment into an FMA:
//     m = fma(g, f32(c1*s), m)      c1 = f32(1-b1), s = f32(scale)
//     v = fma(c2, gs*gs, v)         gs = g*s, c2 = f32(1-b2)
// The wrapper passes cs1 = f32(c1*s); the kernel spells out these
// operations (explicit fmaf, --fmad=false) so the plain PyTorch version in
// adama_accum.py and the reference agree with it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWavesPerSm = 8;

__device__ __forceinline__ void accum1(float& m, float& v, float g, float s,
                                       float cs1, float c2) {
  const float gs = g * s;
  m = fmaf(g, cs1, m);
  v = fmaf(c2, gs * gs, v);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adama_accum_kernel(float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ g, int64_t n, float s,
                   float cs1, float c2) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 gg = g4[i];
      float4 mm = m4[i];
      float4 vv = v4[i];
      accum1(mm.x, vv.x, gg.x, s, cs1, c2);
      accum1(mm.y, vv.y, gg.y, s, cs1, c2);
      accum1(mm.z, vv.z, gg.z, s, cs1, c2);
      accum1(mm.w, vv.w, gg.w, s, cs1, c2);
      m4[i] = mm;
      v4[i] = vv;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float mm = m[i], vv = v[i];
    accum1(mm, vv, g[i], s, cs1, c2);
    m[i] = mm;
    v[i] = vv;
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
extern "C" int adama_accum_launch(void* m, void* v, const void* g, int64_t n,
                                  float s, float cs1, float c2,
                                  void* stream) {
  const bool vec =
      (((uintptr_t)m | (uintptr_t)v | (uintptr_t)g) % 16) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    adama_accum_kernel<true><<<grid_for(n / 4 > 0 ? n / 4 : n), kThreads, 0,
                               st>>>((float*)m, (float*)v, (const float*)g, n,
                                     s, cs1, c2);
  } else {
    adama_accum_kernel<false><<<grid_for(n), kThreads, 0, st>>>(
        (float*)m, (float*)v, (const float*)g, n, s, cs1, c2);
  }
  return (int)cudaGetLastError();
}
