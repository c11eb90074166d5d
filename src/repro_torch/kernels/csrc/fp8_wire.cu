// The fp8 (e4m3) gradient wire's two passes for Hopper (sm_90a), beside the
// fold kernels of fused_step.cu, which decode the wire in-pass. The
// reference computes both in plain jnp, outside its Pallas kernels:
//
// fp8_encode     the encode, `kernels/adama_accum.py::fp8_encode_rows`
//                (fp8_scale_rows, fp8_quantize_rows), with the
//                error-feedback residual injected first
//                (core/accumulation.py's guarded adama, core/layerwise.py::
//                _fp8_wire_slab) and the guard's finite flag of the injected
//                slab ANDed into ok:
//                  x    = fma(ef, S, slab)       (slab alone without ef)
//                  s[r] = rowmax|x| * f32(1/448), flushed; the row max
//                         itself where that flushed to zero; 1.0 where the
//                         max is 0 or NaN
//                  q    = e4m3(x / s[r])          nearest even, saturating
//                  ok   = ok AND every x finite
// fp8_ef_update  the residual's update (the same engines'
//                `(slab - fp8_decode_rows(codes, gs)) / S`): where ok != 0,
//                  ef   = fma(-q, s[r], x) / S
//                with x formed again from the slab and the old ef exactly
//                as fp8_encode formed it; with ok == 0 it writes nothing
//                (the reference's where(ok, ef_new, ef)).
//
// S is a device float (the live loss scale, or the layer-wise engine's
// 1 / fold_scale), read where it is used, so no host copy is made. The
// residual is stored unscaled, so that a dynamic scale may change between
// micro-batches.
//
// The flag. x is non-finite exactly where the reference's check fails: the
// adama engine tests isfinite(x) over the injected slab, the layer-wise one
// isfinite(codes), and a finite x always encodes to a finite code while a
// NaN in x stays NaN and an inf makes its row's scale inf and its own code
// inf/inf = NaN. A warp that saw a non-finite x stores 0.0f into ok (never a
// read, never another value; finite_and's contract in fused_step.cu), so no
// separate finite_and pass is needed.
//
// Rounding. The reference's CPU lowering (XLA) contracts slab + ef*S into
// fma(ef, S, slab) and slab - q*s into fma(-q, s, slab); the kernels spell
// both out (explicit fmaf, --fmad=false) and divide IEEE-rounded. XLA CPU
// also reads subnormal operands as zero and flushes subnormal results; both
// kernels do the same after every operation and on every input read (`fl`),
// which the scale's fallback relies on (a row max of 1e-37 has a subnormal
// max / 448). The row max propagates NaN (jnp.max does; CUDA's fmaxf drops
// it): a separate NaN test per row.
//
// The cast. cvt.rn.satfinite.e4m3x2.f32 rounds to nearest even and
// saturates: above 448 + 16 = 464 in magnitude (and for +-inf) it gives
// +-448, as torch's cast does (kernels/fp8_wire.py's plain version clamps
// to +-448 first, so on every torch build); XLA gives NaN there. The scale
// puts a finite row's max at 448, so only a finite element of a row that
// holds a NaN (scale 1.0) can pass 464, and that micro-batch is skipped.
// NaN gives a NaN code. Up to 464 the three casts agree bit for bit (464,
// a tie, rounds to even 448; signed zeros and subnormal codes included).
//
// Design. One warp per 1024-lane row (the fold kernels' layout: lane l holds
// elements 4 (32k + l) + e, k < 8, e < 4): the row stays in registers between
// its max and its codes, so the slab and the residual are read once. A lane
// writes its 4 codes of float4 k as one 4-byte word. Bounds (bytes, 3.35
// TB/s) at the stablelm-1.6b arena (1,646,002,176 elements): fp8_encode
// with the residual reads slab and ef (8 B) and writes a code (1 B), 9 B,
// 14.81 GB, >= 4.42 ms (5 B without the residual); fp8_ef_update reads
// slab, ef and a code and writes ef, 13 B, 21.40 GB, >= 6.39 ms.

#include <cuda_fp8.h>
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
constexpr float kFp8Inv = 0x1.24924ap-9f;   // float32(1/448)

// XLA CPU's flush of a subnormal to a zero of its sign.
__device__ __forceinline__ float fl(float x) {
  return fabsf(x) < kTiny ? copysignf(0.0f, x) : x;
}

__device__ __forceinline__ int64_t f4_index(int64_t row, int k, int lane) {
  return row * (kLanes / 4) + k * 32 + lane;
}

// A float8_e4m3fn code as the float32 of the same value, exactly
// (fused_step.cu's e4m3_to_f32).
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24, e = (b >> 3) & 0xfu, m = b & 7u;
  float x;
  if (e == 0xfu && m == 7u) x = __uint_as_float(0x7fc00000u);
  else if (e == 0u) x = (float)m * 0x1p-9f;
  else x = __uint_as_float(((e + 120u) << 23) | (m << 20));
  return __uint_as_float(__float_as_uint(x) | sign);
}

// The injected value of one element: fma(ef, S, slab).
__device__ __forceinline__ float inject(float slab, float ef, float s) {
  return fl(fmaf(fl(ef), s, fl(slab)));
}

// x[] = the lane's 32 injected values of row r (EF), or of the slab alone.
template <bool EF>
__device__ __forceinline__ void load_x(float* x,
                                       const float4* __restrict__ slab,
                                       const float4* __restrict__ ef,
                                       float s, int64_t r, int lane) {
#pragma unroll
  for (int k = 0; k < kRowF4; ++k) {
    const float4 a = slab[f4_index(r, k, lane)];
    if constexpr (EF) {
      const float4 e = ef[f4_index(r, k, lane)];
      x[4 * k + 0] = inject(a.x, e.x, s);
      x[4 * k + 1] = inject(a.y, e.y, s);
      x[4 * k + 2] = inject(a.z, e.z, s);
      x[4 * k + 3] = inject(a.w, e.w, s);
    } else {
      x[4 * k + 0] = fl(a.x);
      x[4 * k + 1] = fl(a.y);
      x[4 * k + 2] = fl(a.z);
      x[4 * k + 3] = fl(a.w);
    }
  }
}

// EF: inject the residual; OK: AND the finite flag into *ok.
template <bool EF, bool OK>
__global__ void __launch_bounds__(kThreads)
fp8_encode_kernel(const float4* __restrict__ slab,
                  const float4* __restrict__ ef, const float* __restrict__ S,
                  uint32_t* __restrict__ codes, float* __restrict__ scale,
                  float* __restrict__ ok, int64_t rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const float sv = EF ? fl(*S) : 0.0f;
  bool bad = false;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32; r < rows;
       r += warps) {
    float x[kRowVals];
    load_x<EF>(x, slab, ef, sv, r, lane);
    float mx = 0.0f;
    bool nan = false;
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) {
      mx = fmaxf(mx, fabsf(x[j]));
      nan |= x[j] != x[j];
      bad |= !isfinite(x[j]);
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = 1.0f;
    if (!__any_sync(0xffffffffu, nan)) {
      s = fl(mx * kFp8Inv);
      if (s == 0.0f && mx > 0.0f) s = mx;
      if (!(s > 0.0f)) s = 1.0f;
    }
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      const __nv_fp8x2_storage_t lo = __nv_cvt_float2_to_fp8x2(
          make_float2(x[4 * k + 0] / s, x[4 * k + 1] / s), __NV_SATFINITE,
          __NV_E4M3);
      const __nv_fp8x2_storage_t hi = __nv_cvt_float2_to_fp8x2(
          make_float2(x[4 * k + 2] / s, x[4 * k + 3] / s), __NV_SATFINITE,
          __NV_E4M3);
      codes[f4_index(r, k, lane)] = (uint32_t)lo | ((uint32_t)hi << 16);
    }
    if (lane == 0) scale[r] = s;
  }
  if (OK && __any_sync(0xffffffffu, bad) && lane == 0) *ok = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
fp8_ef_update_kernel(float4* __restrict__ ef, const float4* __restrict__ slab,
                     const uint32_t* __restrict__ codes,
                     const float* __restrict__ scale,
                     const float* __restrict__ S,
                     const float* __restrict__ ok, int64_t rows) {
  __shared__ float so;
  if (threadIdx.x == 0) so = *ok;
  __syncthreads();
  if (so == 0.0f) return;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const float sv = fl(*S);
  for (int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32; r < rows;
       r += warps) {
    const float sr = fl(scale[r]);
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      const int64_t i = f4_index(r, k, lane);
      const float4 a = slab[i];
      const float4 e = ef[i];
      const uint32_t c = codes[i];
      const float xs[4] = {a.x, a.y, a.z, a.w};
      const float es[4] = {e.x, e.y, e.z, e.w};
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = inject(xs[q], es[q], sv);
        const float d = e4m3_to_f32((c >> (8 * q)) & 0xffu);
        y[q] = fl(fl(fmaf(-d, sr, x)) / sv);
      }
      ef[i] = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

int rows_grid(int64_t rows) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (rows + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * kWavesPerSm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes by
// kernels/fp8_wire.py). Every operand is (rows, 1024) and 16-byte aligned
// (the wrapper checks it) but the (rows, 1) scale column and the device
// floats S and ok. fp8_encode_launch: ef NULL encodes the slab alone (S is
// then not read); ok NULL takes no flag. fp8_ef_update_launch: ef updated in
// place where *ok != 0. Each returns cudaGetLastError() after the launch.
extern "C" int fp8_encode_launch(const void* slab, const void* ef,
                                 const void* S, void* codes, void* scale,
                                 void* ok, int64_t rows, void* stream) {
  if (ef != nullptr && S == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = rows_grid(rows);
  const float4* x = (const float4*)slab;
  const float4* e = (const float4*)ef;
  const float* s = (const float*)S;
  uint32_t* q = (uint32_t*)codes;
  float* sc = (float*)scale;
  float* f = (float*)ok;
  if (e != nullptr && f != nullptr)
    fp8_encode_kernel<true, true><<<grid, kThreads, 0, st>>>(x, e, s, q, sc,
                                                             f, rows);
  else if (e != nullptr)
    fp8_encode_kernel<true, false><<<grid, kThreads, 0, st>>>(x, e, s, q, sc,
                                                              f, rows);
  else if (f != nullptr)
    fp8_encode_kernel<false, true><<<grid, kThreads, 0, st>>>(x, e, s, q, sc,
                                                              f, rows);
  else
    fp8_encode_kernel<false, false><<<grid, kThreads, 0, st>>>(x, e, s, q,
                                                               sc, f, rows);
  return (int)cudaGetLastError();
}

extern "C" int fp8_ef_update_launch(void* ef, const void* slab,
                                    const void* codes, const void* scale,
                                    const void* S, const void* ok,
                                    int64_t rows, void* stream) {
  if (ef == nullptr || S == nullptr || ok == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  fp8_ef_update_kernel<<<rows_grid(rows), kThreads, 0, st>>>(
      (float4*)ef, (const float4*)slab, (const uint32_t*)codes,
      (const float*)scale, (const float*)S, (const float*)ok, rows);
  return (int)cudaGetLastError();
}
