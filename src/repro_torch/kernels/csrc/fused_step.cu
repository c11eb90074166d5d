// Arena-wide fused AdamA optimizer kernels for Hopper (sm_90a), one
// template on the (m codec, v codec) pair for each of the reference's three
// Pallas kernels (repro/kernels/fused_step.py, fp32 gradient wire,
// unguarded, static scale):
//
// arena_fold  replaces fused_step.py::arena_fold (_fold_body):
//               gs = g*s
//               m  = dm*m + (1-b1)*gs        in m's codec, in place
//               v  = dv*v + (1-b2)*gs^2      in v's codec, in place
//             The first fold of a mini-batch passes (dm, dv) = (b1, b2),
//             which fuses the begin-minibatch decay into it; later folds
//             pass (1, 1).
// arena_fold_slice replaces fused_step.py::arena_fold_slice
//             (_slice_fold_body): the same arithmetic on arena rows
//             [off, off + rows_g) only, g being a (rows_g, 1024) slab; no
//             other row is read or written. Algorithm 2 launches it once
//             per layer and once for the rest region. It is the fold's
//             kernel with a row offset (the whole-arena fold passes 0).
// arena_apply replaces fused_step.py::arena_apply (_apply_body, no master
//             params), decoding both moments in-pass:
//               p = p - lr*(m/bc1 / (sqrt(v/bc2) + eps) + wd*p)   in place
//
// Codecs (the reference's _KERNEL_CODECS; m in {fp32, int8}, v in {fp32,
// int8, factored}, six pairs):
//   fp32      (rows, 1024) fp32
//   int8 m    (rows, 1024) int8 codes + (rows, 1) fp32 scales; the update
//             decodes q*s, folds, and re-encodes the row: s = rowmax|m|/127,
//             codes trunc(m/s) in [-127, 127]
//   int8 v    the same with codes ceil(v/s) in [0, 127], s = rowmax(v)/127
//   factored  v as a (rows, 1) fp32 statistic: dv*f + c2*rowmax((s*g)^2)
//
// Design. The int8 re-encode needs the updated row's max before any code is
// written, and the factored statistic is a row max, so one warp owns whole
// 1024-lane rows (a grid-stride loop over rows, grid sized to a few waves
// of the SMs): it loads the row once (float4 for g and fp32 columns, 4
// codes at a time, neighbouring lanes on neighbouring addresses), updates
// it in registers, takes the max with warp shuffles, then encodes and
// stores it. Every form is row-local: no atomics, no second pass, one
// launch per call for every pair. The apply decodes both moments in
// registers (no fp32 copy of a compressed moment is ever made). Every pass
// streams its operands once and does a handful of fp32 operations per
// element, far below the card's fp32 rate, so it is bound by device-memory
// bandwidth.
//
// Bounds (bytes, each input read once, each output written once, at the
// data sheet's 3.35 TB/s). fp32/fp32 at the bert-large arena (357,888 x
// 1024 = 366,477,312 elements): fold 20 B per element (m, v, g read, m, v
// written) 7.33 GB, >= 2.19 ms; apply 16 B, 5.86 GB, >= 1.75 ms; a layer
// slice of 12,352 rows 253 MB, >= 0.0755 ms; the rest region of 61,248
// rows 1.25 GB, >= 0.374 ms. At stablelm-1.6b's arena (1,607,424 x 1024 =
// 1,646,002,176 elements): int8/int8 fold 8 B per element (g 4, codes 2 x
// (1 + 1), the scales negligible) 13.19 GB, >= 3.94 ms; int8/factored fold
// 6 B, 9.90 GB, >= 2.96 ms; int8/int8 apply 10 B (p 4 + 4, codes 2), 16.47
// GB, >= 4.92 ms; int8/factored apply 9 B, 14.83 GB, >= 4.43 ms.
//
// Rounding. The reference's CPU lowering (XLA) contracts
//   fp32      d*m + c*x       as fma(d, m, c*x)
//   int8 m    d*(q*s) + c*x   as fma(c, x, d*(q*s))
//   int8 v    d*(q*s) + c*x   as fma(d, q*s, c*x)
//   factored  d*f + c*max(x)  as fma(d, f, c*max(x))
//   apply     (m/bc1)/(sqrt(v/bc2) + eps)  as m / (bc1*(sqrt(v/bc2) + eps))
//             u + wd*p        as fma(wd, p, u)
//             p - lr*u        as fma(-lr, u, p)
// with x = s*g for m and (s*g)^2 for v. The kernels spell out exactly these
// operations (explicit fmaf) and are compiled with --fmad=false so that
// nvcc contracts nothing else; divisions (v/s, m/s, the apply's) and sqrtf
// are IEEE-rounded (no --use_fast_math). XLA CPU also reads subnormal
// operands as zero and flushes subnormal results to zero. Every pair but
// fp32/fp32 does the same, explicitly (`fl`, a flush after every operation
// and on every input read), so that no compiler flag is needed; the
// fp32/fp32 instantiation keeps IEEE subnormals (bert-large and rwkv6 run
// it, and their checks hold it to its plain version's IEEE arithmetic).
// The plain PyTorch versions in fused_step.py compute the same
// expressions, so kernel, plain version and reference agree bit for bit
// (fp32/fp32 where no value falls below 2^-126).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kLanes = 1024;            // arena row width
constexpr int kWavesPerSm = 8;
constexpr int kRowF4 = kLanes / 4 / 32;     // float4 per lane in a row (8)
constexpr int kRowVals = kRowF4 * 4;        // values per lane in a row (32)
constexpr float kTiny = 1.17549435e-38f;    // 2^-126, the least normal
constexpr float kQ8Max = 127.0f;
constexpr float kQ8Inv = 0x1.020408p-7f;    // float32(1/127)

enum Kind { kFp32 = 0, kInt8 = 1, kFactored = 2 };

// XLA CPU's flush of a subnormal to a zero of its sign, when F (every pair
// but fp32/fp32); the identity otherwise.
template <bool F>
__device__ __forceinline__ float fl(float x) {
  return F && fabsf(x) < kTiny ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// lane's value j of a row lies at element 4 * ((j / 4) * 32 + lane) + j % 4
__device__ __forceinline__ int64_t f4_index(int64_t row, int k, int lane) {
  return row * (kLanes / 4) + k * 32 + lane;
}

// The row scale of the int8 codecs: rowmax * f32(1/127), flushed; a row
// whose scale flushed to zero while its max did not takes the max itself.
__device__ __forceinline__ float q8_scale(float rowmax) {
  const float s = fl<true>(rowmax * kQ8Inv);
  return (s == 0.0f && rowmax > 0.0f) ? rowmax : s;
}

// Re-encode a row held in registers (x[]: the lane's 32 values) into codes
// and its scale. V: ceil over [0, 127] (v >= 0); else trunc over
// [-127, 127] with the scale from max |m|.
template <bool V>
__device__ __forceinline__ void q8_store(const float* x,
                                         char4* __restrict__ codes,
                                         float* __restrict__ scales,
                                         int64_t row, int lane) {
  float mx = 0.0f;
#pragma unroll
  for (int j = 0; j < kRowVals; ++j) mx = fmaxf(mx, V ? x[j] : fabsf(x[j]));
  mx = warp_max(mx);
  const float s = q8_scale(mx);
  const float sd = s > 0.0f ? s : 1.0f;
#pragma unroll
  for (int k = 0; k < kRowF4; ++k) {
    signed char q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = fl<true>(x[4 * k + e] / sd);
      const float c = V ? fminf(fmaxf(ceilf(r), 0.0f), kQ8Max)
                        : fminf(fmaxf(truncf(r), -kQ8Max), kQ8Max);
      q[e] = (signed char)(int)c;
    }
    codes[f4_index(row, k, lane)] = make_char4(q[0], q[1], q[2], q[3]);
  }
  if (lane == 0) scales[row] = s;
}

// Fold contributions x[] (the lane's 32 values of s*g, or of (s*g)^2 for
// v) into one moment's row, in its codec's space. F: flush (see fl).
template <int K, bool V, bool F>
__device__ __forceinline__ void fold_moment(void* __restrict__ c0,
                                            void* __restrict__ c1,
                                            const float* x, float d,
                                            float c, int64_t row, int lane) {
  if (K == kFp32) {
    float4* col = (float4*)c0;
    float4 a[kRowF4];
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) a[k] = col[f4_index(row, k, lane)];
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      a[k].x = fl<F>(fmaf(d, fl<F>(a[k].x), fl<F>(c * x[4 * k + 0])));
      a[k].y = fl<F>(fmaf(d, fl<F>(a[k].y), fl<F>(c * x[4 * k + 1])));
      a[k].z = fl<F>(fmaf(d, fl<F>(a[k].z), fl<F>(c * x[4 * k + 2])));
      a[k].w = fl<F>(fmaf(d, fl<F>(a[k].w), fl<F>(c * x[4 * k + 3])));
      col[f4_index(row, k, lane)] = a[k];
    }
  } else if (K == kInt8) {                  // F is true for every int8 pair
    char4* codes = (char4*)c0;
    float* scales = (float*)c1;
    const float s = fl<true>(scales[row]);
    float y[kRowVals];
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      const char4 q = codes[f4_index(row, k, lane)];
      const signed char qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * k + e;
        const float dec = fl<true>((float)qs[e] * s);
        y[j] = V ? fl<true>(fmaf(d, dec, fl<true>(c * x[j])))
                 : fl<true>(fmaf(c, x[j], fl<true>(d * dec)));
      }
    }
    q8_store<V>(y, codes, scales, row, lane);
  } else {                                    // factored (v only)
    float* stat = (float*)c0;
    float mx = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) mx = fmaxf(mx, x[j]);
    mx = warp_max(mx);
    const float f = fl<true>(stat[row]);
    if (lane == 0) stat[row] = fl<true>(fmaf(d, f, fl<true>(c * mx)));
  }
}

// One warp per row of the slab; slab row r folds into arena row off + r.
template <int MK, int VK>
__global__ void __launch_bounds__(kThreads)
arena_fold_kernel(void* __restrict__ m0, void* __restrict__ m1,
                  void* __restrict__ v0, void* __restrict__ v1,
                  const float4* __restrict__ g, int64_t off, int64_t rows_g,
                  float s, float c1, float c2, float dm, float dv) {
  constexpr bool F = MK != kFp32 || VK != kFp32;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       r < rows_g; r += warps) {
    float x[kRowVals];
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      const float4 a = g[f4_index(r, k, lane)];
      x[4 * k + 0] = fl<F>(fl<F>(a.x) * s);
      x[4 * k + 1] = fl<F>(fl<F>(a.y) * s);
      x[4 * k + 2] = fl<F>(fl<F>(a.z) * s);
      x[4 * k + 3] = fl<F>(fl<F>(a.w) * s);
    }
    fold_moment<MK, false, F>(m0, m1, x, dm, c1, off + r, lane);
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) x[j] = fl<F>(x[j] * x[j]);
    fold_moment<VK, true, F>(v0, v1, x, dv, c2, off + r, lane);
  }
}

// The lane's 4 values of float4 k of a row, decoded to fp32.
template <int K, bool F>
__device__ __forceinline__ float4 decode4(const void* __restrict__ c0,
                                          const void* __restrict__ c1,
                                          int64_t row, int k, int lane) {
  if (K == kFp32) {
    const float4 a = ((const float4*)c0)[f4_index(row, k, lane)];
    return make_float4(fl<F>(a.x), fl<F>(a.y), fl<F>(a.z), fl<F>(a.w));
  }
  if (K == kInt8) {
    const char4 q = ((const char4*)c0)[f4_index(row, k, lane)];
    const float s = fl<true>(((const float*)c1)[row]);
    return make_float4(fl<true>((float)q.x * s), fl<true>((float)q.y * s),
                       fl<true>((float)q.z * s), fl<true>((float)q.w * s));
  }
  const float f = fl<true>(((const float*)c0)[row]);  // factored: the row's
  return make_float4(f, f, f, f);                     // statistic, broadcast
}

template <bool F>
__device__ __forceinline__ float apply1(float p, float m, float v, float lr,
                                        float bc1, float bc2, float eps,
                                        float wd) {
  p = fl<F>(p);
  const float den = fl<F>(bc1 * fl<F>(fl<F>(sqrtf(fl<F>(v / bc2))) + eps));
  float u = fl<F>(m / den);
  if (wd != 0.0f) u = fl<F>(fmaf(wd, p, u));
  return fl<F>(fmaf(-lr, u, p));
}

template <int MK, int VK>
__global__ void __launch_bounds__(kThreads)
arena_apply_kernel(float4* __restrict__ p, const void* __restrict__ m0,
                   const void* __restrict__ m1, const void* __restrict__ v0,
                   const void* __restrict__ v1, int64_t rows, float lr,
                   float bc1, float bc2, float eps, float wd) {
  constexpr bool F = MK != kFp32 || VK != kFp32;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       r < rows; r += warps) {
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      const float4 mm = decode4<MK, F>(m0, m1, r, k, lane);
      const float4 vv = decode4<VK, F>(v0, v1, r, k, lane);
      float4 pp = p[f4_index(r, k, lane)];
      pp.x = apply1<F>(pp.x, mm.x, vv.x, lr, bc1, bc2, eps, wd);
      pp.y = apply1<F>(pp.y, mm.y, vv.y, lr, bc1, bc2, eps, wd);
      pp.z = apply1<F>(pp.z, mm.z, vv.z, lr, bc1, bc2, eps, wd);
      pp.w = apply1<F>(pp.w, mm.w, vv.w, lr, bc1, bc2, eps, wd);
      p[f4_index(r, k, lane)] = pp;
    }
  }
}

// Blocks for `rows` rows, one warp each, capped at a few waves of the SMs.
int rows_grid(int64_t rows) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (rows + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * kWavesPerSm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

template <int MK, int VK>
void fold(void* m0, void* m1, void* v0, void* v1, const void* g, int64_t off,
          int64_t rows_g, float s, float c1, float c2, float dm, float dv,
          cudaStream_t stream) {
  arena_fold_kernel<MK, VK><<<rows_grid(rows_g), kThreads, 0, stream>>>(
      m0, m1, v0, v1, (const float4*)g, off, rows_g, s, c1, c2, dm, dv);
}

template <int MK, int VK>
void apply(void* p, const void* m0, const void* m1, const void* v0,
           const void* v1, int64_t rows, float lr, float bc1, float bc2,
           float eps, float wd, cudaStream_t stream) {
  arena_apply_kernel<MK, VK><<<rows_grid(rows), kThreads, 0, stream>>>(
      (float4*)p, m0, m1, v0, v1, rows, lr, bc1, bc2, eps, wd);
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes). mk: m's kind (0
// fp32, 1 int8); vk: v's (0 fp32, 1 int8, 2 factored). m0/m1 and v0/v1 are
// each moment's columns over the whole arena (the second NULL for a
// one-column codec); every pointer is 16-byte aligned (the Python wrappers
// check it). Each returns cudaGetLastError() after the launch, so a refused
// launch or an unknown pair surfaces as a non-zero code.
#define PAIRS(X)                                                        \
  X(kFp32, kFp32) X(kFp32, kInt8) X(kFp32, kFactored) X(kInt8, kFp32) \
  X(kInt8, kInt8) X(kInt8, kFactored)

// g is the (rows_g, 1024) slab for arena rows [row_offset, row_offset +
// rows_g), inside the arena (checked by the wrapper); the whole-arena fold
// passes row_offset 0 and rows_g = the arena's rows.
extern "C" int arena_fold_launch(int mk, int vk, void* m0, void* m1,
                                 void* v0, void* v1, const void* g,
                                 int64_t row_offset, int64_t rows_g, float s,
                                 float c1, float c2, float dm, float dv,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mk * 3 + vk) {
#define FOLD(MK, VK)                                                       \
  case MK * 3 + VK:                                                        \
    fold<MK, VK>(m0, m1, v0, v1, g, row_offset, rows_g, s, c1, c2, dm, dv, \
                 st);                                                      \
    break;
    PAIRS(FOLD)
#undef FOLD
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int arena_apply_launch(int mk, int vk, void* p, const void* m0,
                                  const void* m1, const void* v0,
                                  const void* v1, int64_t rows, float lr,
                                  float bc1, float bc2, float eps, float wd,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mk * 3 + vk) {
#define APPLY(MK, VK)                                                   \
  case MK * 3 + VK:                                                     \
    apply<MK, VK>(p, m0, m1, v0, v1, rows, lr, bc1, bc2, eps, wd, st); \
    break;
    PAIRS(APPLY)
#undef APPLY
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
