// Arena-wide fused AdamA optimizer kernels for Hopper (sm_90a), one
// template on the (m codec, v codec) pair for each of the reference's three
// Pallas kernels (repro/kernels/fused_step.py), each in its unguarded
// static-scale form and its guarded traced-scale form, the folds on the
// fp32, bf16 and e4m3 gradient wires, and the finite flag the guard reads:
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
// arena_apply replaces fused_step.py::arena_apply (_apply_body), decoding
//             both moments in-pass:
//               p = p - lr*(m/bc1 / (sqrt(v/bc2) + eps) + wd*p)   in place
//             and, in its master form (work_dtype=bf16: p is the fp32
//             master), also work = bf16(p) of the new p, rounded to
//             nearest even, in the same pass.
// finite_and  ok <- ok AND (every element of x is finite), over a contiguous
//             fp32 or bf16 tensor, in place. The reference computes this
//             flag outside its kernels (jnp.isfinite(g).all() in
//             fused_step.py::_fold_guard_setup and the engines); here it is
//             one pass that reads x once and writes nothing but, where it
//             finds an Inf or a NaN, 0.0f into ok: plain stores of one
//             value, no float atomics, and no (rows, 1024) bool tensor.
//
// The guarded forms (the reference's _guard_scalars, _GuardedRef and the
// apply's guard) take a device float vector instead of host scalars: [dm,
// dv, ok, s] for a fold, [ok] for the apply, loaded once per CTA into
// shared memory. With ok == 0 every CTA returns before its first write, so
// the state (the row-indexed columns, rowcol's column partials, ticket and
// column sums) or p keeps every byte: in place, an early return is the
// bitwise no-op that the reference's where(ok, new, old) gives, NaNs of a
// bc1 = 0 apply included. With ok != 0 the arithmetic is the unguarded
// kernel's with the vector's values. Each kernel template takes the form as
// a flag (G), so the unguarded instantiations compile as they did before
// the guard existed; a NULL vector launches them.
//
// The master form (the reference's `emit_work`): each apply template takes
// a flag (E) that adds the (rows, 1024) bf16 output `work`. A lane rounds
// the 4 values of each float4 of the new p (already flushed by `fl`) with
// __float2bfloat16_rn and stores them as one 8-byte word, the mirror of the
// bf16 wire's load. The guarded master form with ok == 0 does not return
// early: p keeps every byte, and work is still written, as bf16(p) of the
// unchanged p (the reference's where(ok, p_new, p) is cast to work after
// the select), so a skipped step's working params are the master's.
//
// The gradient wire (the reference's `_fold_body`, g.astype(float32) * s):
// each fold template takes the wire of g as a parameter (W). On the fp32
// wire a lane loads a float4 of g; on the bf16 wire the same 4 elements as
// one 8-byte word and widens each exactly (a bf16 value is the high half of
// a float32: __uint_as_float(bits << 16)). The row stays in registers with
// the same lane mapping, so everything after the load is the fp32 wire's
// arithmetic: a fold of a bf16 slab equals the fp32 fold of that slab
// upcast on the host, bit for bit. A bf16 row is 2 KiB, so the wrapper's
// 16-byte alignment check still covers every 8-byte load. On the e4m3 wire
// (the reference's `grad_scale` operand) a lane loads the same 4 elements
// as one 4-byte word of float8_e4m3fn codes and widens each exactly (every
// e4m3 value is a float32); the row's scale column entry gs[r] is read once
// per row, and the decode takes the reference's order, x = (code * s) * gs
// (`_fold_body`: the upcast times s, then times the scale column), flushed
// after each product in the flushing pairs. Everything after it is again
// the fp32 wire's arithmetic, and rowcol's column partials take the same x
// as its row sums. A NaN code (the encoder's signal of a non-finite
// gradient) widens to NaN: only a guarded fold with ok == 0 (the encoder
// ANDs that flag) ever sees one, and it writes nothing.
//
// Codecs (the reference's _KERNEL_CODECS; m in {fp32, int8}, v in {fp32,
// int8, factored, rowcol}, eight pairs):
//   fp32      (rows, 1024) fp32
//   int8 m    (rows, 1024) int8 codes + (rows, 1) fp32 scales; the update
//             decodes q*s, folds, and re-encodes the row: s = rowmax|m|/127,
//             codes trunc(m/s) in [-127, 127]
//   int8 v    the same with codes ceil(v/s) in [0, 127], s = rowmax(v)/127
//   factored  v as a (rows, 1) fp32 statistic: dv*f + c2*rowmax((s*g)^2)
//   rowcol    v as its marginals (Adafactor): (rows, 1) fp32 row sums
//             vr = dv*vr + c2*rowsum((s*g)^2) and one (1, 1024) fp32 block of
//             column sums vc = vc + c2*colsum((s*g)^2) over every row the call
//             folds (its decay is the caller's, once per micro-batch); the
//             apply decodes v = vr[row] * vc[col] / max(sum(vc), 1e-30)
//
// Design. The int8 re-encode needs the updated row's max before any code is
// written, and the factored statistic is a row max, so one warp owns whole
// 1024-lane rows (a grid-stride loop over rows, grid sized to a few waves
// of the SMs): it loads the row once (float4 for g and fp32 columns, 4
// codes at a time, neighbouring lanes on neighbouring addresses), updates
// it in registers, takes the max with warp shuffles, then encodes and
// stores it. Every form but rowcol's fold is row-local: no atomics, no
// second pass, one launch per call for every pair. The apply decodes both
// moments in registers (no fp32 copy of a compressed moment is ever made).
//
// Rowcol's column sums are shared by every row, and CTAs run in no set
// order, so its fold is a kernel of its own (rowcol_fold_kernel). The rows
// are cut into P ranges of L rows that depend on the row count alone
// (fused_step.py::rowcol_partition, which the wrapper passes in; never the
// card's SM count), one CTA per range. In a CTA, warp w folds rows
// lo + w, lo + w + 8, ... and adds each row's (s*g)^2 into its lanes'
// column partials in that order (in registers, or in shared memory when
// the int8 m codec needs the registers); the 8 warps' partials meet in a
// fixed tree through shared memory and go to row p of a (P, 1024) fp32
// scratch. Each CTA then takes an integer ticket (after __threadfence;
// the launcher zeroes it). The CTAs holding the last K tickets (K a power
// of two, at most 64 and at most P: rowcol_ordered) wait until all P are
// taken, then each adds the P partials of its 1024 / K columns in order
// p = 0, 1, ... (the partials stream through shared memory, all 256
// threads loading, one thread per column adding) and folds the totals into
// vc: one launch, no float atomics, the same bits on every run and every
// card, whatever K is. Waiting is safe: only the holders of the last K
// tickets wait, and K is kept below the number of this kernel's CTAs the
// card holds at once, so a slot is always free for a CTA not yet run. The
// row sums come from the same tree in every warp: a halving tree over the
// lane's 32 values, then shuffles down. The apply forms vc / max(sum(vc),
// 1e-30) once per CTA in shared memory (the sum in a fixed tree), then
// v = vr[row] * that[col] in registers. Every pass streams its operands
// once and does a handful of fp32 operations per element, far below the
// card's fp32 rate, so it is bound by device-memory bandwidth, or, where
// few bytes move per element, by the instructions it issues.
//
// The int8-m rowcol fold (the fold with the fewest bytes an element: 3 on
// the e4m3 wire) is written for the instructions it issues and for the
// latency of a row (rowcol_int8_row): 27-30 lane instructions an element
// on its row loop's path (launch/fold_ab.py --sass; the first design took
// 58-80).
// A warp issues the loads of its next row (g, m's codes, the row's scales
// and vr) before the arithmetic of the current one; the e4m3 wire decodes
// its codes two at a time in hardware (cvt.rn.f16x2.e4m3x2, then an exact
// widening); every flush is the hardware's (`ftz`, one instruction where
// `fl` took three; `add_ftz` and the squares' `mul_ftz` flush in the
// operation itself); the re-encode divides by one reciprocal a row
// (q8m_word). 2 CTAs an SM (at most 128 registers, no stack frame); 3, at
// 80 registers, spill and run 1.0-1.3x slower.
//
// Bounds (bytes, each input read once, each output written once, at the
// data sheet's 3.35 TB/s), for the fp32 wire, whose g is 4 B an element.
// The bf16 wire's g is 2 B, so each fold moves 2 B an element less: at the
// stablelm arena fp32/fp32 18 B, 29.63 GB, >= 8.84 ms; int8/int8 6 B,
// >= 2.95 ms; int8/rowcol 4 B, >= 1.97 ms; and finite_and reads the bf16
// slab (3.29 GB) in >= 0.983 ms. fp32/fp32 at the bert-large arena (357,888 x
// 1024 = 366,477,312 elements): fold 20 B per element (m, v, g read, m, v
// written) 7.33 GB, >= 2.19 ms; apply 16 B, 5.86 GB, >= 1.75 ms; a layer
// slice of 12,352 rows 253 MB, >= 0.0755 ms; the rest region of 61,248
// rows 1.25 GB, >= 0.374 ms. At stablelm-1.6b's arena (1,607,424 x 1024 =
// 1,646,002,176 elements): int8/int8 fold 8 B per element (g 4, codes 2 x
// (1 + 1), the scales negligible) 13.19 GB, >= 3.94 ms; int8/factored fold
// 6 B, 9.90 GB, >= 2.96 ms; int8/int8 apply 10 B (p 4 + 4, codes 2), 16.47
// GB, >= 4.92 ms; int8/factored apply 9 B, 14.83 GB, >= 4.43 ms. Rowcol
// (vr, vc and the 3 MiB scratch negligible): fp32/rowcol fold 12 B (g 4, m
// 4 + 4) 19.75 GB, >= 5.90 ms; int8/rowcol fold 6 B, 9.88 GB, >= 2.95 ms;
// fp32/rowcol apply 12 B, >= 5.90 ms; int8/rowcol apply 9 B, >= 4.42 ms.
// The e4m3 wire's g is 1 B an element (its scale column negligible): at
// the stablelm arena fp32/fp32 17 B, 27.98 GB, >= 8.36 ms; int8/rowcol 3 B,
// >= 1.47 ms. A guarded form moves the same bytes and 16 more (the
// vector). finite_and
// reads each element once: the stablelm slab (6.58 GB fp32) >= 1.965 ms.
// The master form of the apply writes 2 B an element more (work): at the
// stablelm arena fp32/fp32 18 B, 29.63 GB, >= 8.84 ms; int8/rowcol 11 B,
// >= 5.40 ms.
//
// Rounding. The reference's CPU lowering (XLA) contracts
//   fp32      d*m + c*x       as fma(d, m, c*x)
//   int8 m    d*(q*s) + c*x   as fma(c, x, d*(q*s)); on the e4m3 wire as
//             fma(d, q*s, c*x), int8 v's
//   int8 v    d*(q*s) + c*x   as fma(d, q*s, c*x)
//   factored  d*f + c*max(x)  as fma(d, f, c*max(x))
//   rowcol    d*vr + c*sum(x) as fma(d, vr, c*sum(x)); vc + c*sum(x) as
//             fma(c, sum(x), vc); decode vr * (vc / max(sum(vc), 1e-30))
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
// The int8-m rowcol fold computes the same values with fewer
// instructions, each substitution proven equal, on every input, to the
// expression it replaces (fold_exactness_launch holds each on the card):
//   fl(x)             ftz(x) = mul.rn.ftz(x, 1): exact, so only the flush
//                     acts; a product or an fma is rounded IEEE, then
//                     flushed by ftz (the card's own .ftz product flushes
//                     some results that IEEE rounds up to 2^-126)
//   fl(a + b)         add.rn.ftz of flushed a, b: a sum below 2^-126 is
//                     exact, so no rounding carries one up
//   fl(x * x)         mul.rn.ftz(x, x): no square lies where the card's
//                     flush and fl part
//   fl(q * fl(ms))    q * ftz(ms) with no flush: |q| >= 1 and a flushed
//                     scale give 0 or at least 2^-126
//   fl(code)          on the e4m3 wire none: every e4m3 value is normal
//   trunc(fl(m / sd)) the quotient through r = rcp.rn(sd) and one fma
//                     residual step, the correctly rounded m / sd while
//                     2^-103 <= sd < 2^126 (the row takes the divide
//                     outside), clamped before the truncation; the flush
//                     of a quotient below 1 never moves its code
// The plain PyTorch versions in fused_step.py compute the same
// expressions, so kernel, plain version and reference agree bit for bit
// (fp32/fp32 where no value falls below 2^-126). Rowcol's sums are the
// exception: the reference's order is XLA's own, so kernel and plain
// version (the same partition and trees) agree bit for bit, and both lie
// within a stated tolerance of the reference (tests/test_torch_codecs.py).

#include <cuda_bf16.h>
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

enum Kind { kFp32 = 0, kInt8 = 1, kFactored = 2, kRowCol = 3 };
// fused_step.py::WIRES
enum Wire { kWireF32 = 0, kWireBf16 = 1, kWireE4m3 = 2 };
constexpr int kVKinds = 4;                 // the launchers' key: mk * 4 + vk
constexpr float kRcFloor = 1e-30f;          // rowcol's least column total

// XLA CPU's flush of a subnormal to a zero of its sign, when F (every pair
// but fp32/fp32); the identity otherwise.
template <bool F>
__device__ __forceinline__ float fl(float x) {
  return F && fabsf(x) < kTiny ? copysignf(0.0f, x) : x;
}

// The hardware's flush (.ftz): subnormal inputs are read as a zero of
// their sign and a subnormal result is written as one. `ftz(x)` is
// fl<true>(x) in one instruction: x * 1 is exact, so only the flush acts
// (a NaN comes out as the card's canonical NaN). add_ftz(a, b) is
// fl(fl(a) + fl(b)) on every input: the sum of two values that are zero or
// normal is a multiple of 2^-149, so a sum below 2^-126 is exact and no
// rounding can carry it to 2^-126. mul_ftz(x, x) is fl(fl(x) * fl(x)) on
// every input: no square lies in [2^-126 - 2^-150, 2^-126), where the
// card's flush and fl part. A product or an fma in general is not: the
// card flushes some results that IEEE rounding carries up to 2^-126, so
// those are rounded IEEE and then flushed by ftz(). fold_exactness_launch
// holds ftz, add_ftz and the squares against fl on the card, and counts
// where mul_ftz and fma_ftz part from it.
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float d;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}

__device__ __forceinline__ float ftz(float x) { return mul_ftz(x, 1.0f); }

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The guard vector [dm, dv, ok, s] of a fold (fused_step.py::guard_scalars),
// loaded once per CTA into shared memory. Every thread of the CTA must call
// it. The copy is volatile, so each scalar is read where it is used (once
// per row) and no register holds it across a row's phases: held in
// registers, s, dm and dv pushed the int8 m rowcol fold's row arrays onto a
// stack frame (+30% time), where the unguarded form takes them from the
// constant bank as kernel arguments.
enum GuardSlot { kGDm = 0, kGDv = 1, kGOk = 2, kGScale = 3 };

__device__ __forceinline__ const volatile float* fold_guard(
    const float4* __restrict__ guard) {
  __shared__ volatile float sg[4];
  if (threadIdx.x < 4) sg[threadIdx.x] = ((const float*)guard)[threadIdx.x];
  __syncthreads();
  return sg;
}

// The apply's guard [ok], the same way: false when ok == 0.
__device__ __forceinline__ bool apply_guard(const float* __restrict__ guard) {
  __shared__ float so;
  if (threadIdx.x == 0) so = *guard;
  __syncthreads();
  return so != 0.0f;
}

// lane's value j of a row lies at element 4 * ((j / 4) * 32 + lane) + j % 4
__device__ __forceinline__ int64_t f4_index(int64_t row, int k, int lane) {
  return row * (kLanes / 4) + k * 32 + lane;
}

// A float8_e4m3fn code (1 sign, 4 exponent bits of bias 7, 3 mantissa
// bits; S.1111.111 is NaN, there is no inf) as the float32 of the same
// value, exactly: a subnormal code is m * 2^-9, a normal one has the float32
// exponent e + 120 and the mantissa bits on top (csrc/fp8_wire.cu decodes
// the same way).
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24, e = (b >> 3) & 0xfu, m = b & 7u;
  float x;
  if (e == 0xfu && m == 7u) x = __uint_as_float(0x7fc00000u);
  else if (e == 0u) x = (float)m * 0x1p-9f;
  else x = __uint_as_float(((e + 120u) << 23) | (m << 20));
  return __uint_as_float(__float_as_uint(x) | sign);
}

// Four e4m3 codes (element e in bits 8e .. 8e + 7) as float32, by the
// hardware: cvt.rn.f16x2.e4m3x2 on each pair, then each half widened. Both
// steps are exact (every e4m3 value is a normal float16, the least 2^-9,
// the largest 448), so each value is e4m3_to_f32's; a NaN code comes out
// as a NaN of another payload.
__device__ __forceinline__ float4 e4m3x4_to_f32(uint32_t c) {
  float a, b, d, e;
  asm("{\n\t.reg .b16 p0, p1, l0, u0, l1, u1;\n\t.reg .b32 h0, h1;\n\t"
      "mov.b32 {p0, p1}, %4;\n\t"
      "cvt.rn.f16x2.e4m3x2 h0, p0;\n\t"
      "cvt.rn.f16x2.e4m3x2 h1, p1;\n\t"
      "mov.b32 {l0, u0}, h0;\n\t"
      "mov.b32 {l1, u1}, h1;\n\t"
      "cvt.f32.f16 %0, l0;\n\t"
      "cvt.f32.f16 %1, u0;\n\t"
      "cvt.f32.f16 %2, l1;\n\t"
      "cvt.f32.f16 %3, u1;\n\t}"
      : "=f"(a), "=f"(b), "=f"(d), "=f"(e) : "r"(c));
  return make_float4(a, b, d, e);
}

// Elements 4i .. 4i + 3 of the gradient slab g as fp32: one float4 on the
// fp32 wire; on the bf16 wire one 8-byte word of four bf16 (element 4i + e
// in bits 16e .. 16e + 15 of the little-endian word), each widened exactly;
// on the e4m3 wire one 4-byte word of four codes (element 4i + e in bits
// 8e .. 8e + 7), each widened exactly (still to be decoded by the row's
// scale).
template <int W>
__device__ __forceinline__ float4 load_g(const void* __restrict__ g,
                                         int64_t i) {
  if constexpr (W == kWireF32) {
    return ((const float4*)g)[i];
  } else if constexpr (W == kWireE4m3) {
    const uint32_t c = ((const uint32_t*)g)[i];
    return make_float4(e4m3_to_f32(c & 0xffu), e4m3_to_f32((c >> 8) & 0xffu),
                       e4m3_to_f32((c >> 16) & 0xffu), e4m3_to_f32(c >> 24));
  } else {
    const uint2 h = ((const uint2*)g)[i];
    return make_float4(__uint_as_float(h.x << 16),
                       __uint_as_float(h.x & 0xffff0000u),
                       __uint_as_float(h.y << 16),
                       __uint_as_float(h.y & 0xffff0000u));
  }
}

// The row scale of the int8 codecs: rowmax * f32(1/127), flushed; a row
// whose scale flushed to zero while its max did not takes the max itself.
__device__ __forceinline__ float q8_scale(float rowmax) {
  const float s = fl<true>(rowmax * kQ8Inv);
  return (s == 0.0f && rowmax > 0.0f) ? rowmax : s;
}

// int8 m's code of x: trunc(fl(x / sd)) clamped to [-127, 127], the flush
// dropped (a flushed quotient lies below 1 in magnitude, where trunc gives
// 0 either way) and the clamp taken before the truncation (the same code
// for every x, NaN's -127 included). `Recip`: the quotient through
// r = rcp.rn(sd), q = x * r and one residual step q + (x - q * sd) * r
// (two fmas; the residual is exact), which is the correctly rounded x / sd
// (Markstein) while 2^-103 <= sd < 2^126: r is normal and the residual a
// multiple of 2^-149, exact even below 2^-126. Outside that range (a row
// of tiny values, an Inf row max) the row takes the IEEE divide.
template <bool Recip>
__device__ __forceinline__ float q8_quot(float x, float sd, float r) {
  if constexpr (Recip) {
    const float q0 = __fmul_rn(x, r);
    return __fmaf_rn(__fmaf_rn(-q0, sd, x), r, q0);
  } else {
    return __fdiv_rn(x, sd);
  }
}

__device__ __forceinline__ int q8_code(float q) {
  return (int)fminf(fmaxf(q, -kQ8Max), kQ8Max);
}

__device__ __forceinline__ bool q8_recip_ok(float sd) {
  return sd >= 0x1p-103f && sd < 0x1p126f;
}

// The expression q8m_word's codes replace (fold_exactness holds them
// equal).
__device__ __forceinline__ int q8_code_m_div(float x, float sd) {
  const float r = fl<true>(x / sd);
  return (int)fminf(fmaxf(truncf(r), -kQ8Max), kQ8Max);
}

// The int8 m codes of four values as one word, element e in byte e (the
// char4 layout); r = rcp.rn(sd).
template <bool Recip>
__device__ __forceinline__ uint32_t q8m_word(float4 x, float sd, float r) {
  const int a = q8_code(q8_quot<Recip>(x.x, sd, r));
  const int b = q8_code(q8_quot<Recip>(x.y, sd, r));
  const int c = q8_code(q8_quot<Recip>(x.z, sd, r));
  const int d = q8_code(q8_quot<Recip>(x.w, sd, r));
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)d << 24);
}

template <bool Recip>
__device__ __forceinline__ void q8m_codes(const float* x, float sd,
                                          uint32_t* __restrict__ codes,
                                          int64_t row, int lane) {
  const float r = __frcp_rn(sd);
#pragma unroll
  for (int k = 0; k < kRowF4; ++k)
    codes[f4_index(row, k, lane)] = q8m_word<Recip>(
        make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]), sd,
        r);
}

// Re-encode a row held in registers (x[]: the lane's 32 values) into codes
// and its scale. V: ceil over [0, 127] (v >= 0); else trunc over
// [-127, 127] with the scale from max |m| (q8m_word).
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
  if constexpr (V) {
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) {
      signed char q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = fl<true>(x[4 * k + e] / sd);
        q[e] = (signed char)(int)fminf(fmaxf(ceilf(r), 0.0f), kQ8Max);
      }
      codes[f4_index(row, k, lane)] = make_char4(q[0], q[1], q[2], q[3]);
    }
  } else if (q8_recip_ok(sd)) {
    q8m_codes<true>(x, sd, (uint32_t*)codes, row, lane);
  } else {
    q8m_codes<false>(x, sd, (uint32_t*)codes, row, lane);
  }
  if (lane == 0) scales[row] = s;
}

// Fold contributions x[] (the lane's 32 values of s*g, or of (s*g)^2 for
// v) into one moment's row, in its codec's space. F: flush (see fl). DF:
// int8's d-first contraction fma(d, q*s, c*x), which XLA CPU takes for v
// and, on the e4m3 wire, for m too (the header's Rounding).
template <int K, bool V, bool F, bool DF = V>
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
        y[j] = DF ? fl<true>(fmaf(d, dec, fl<true>(c * x[j])))
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

// x[] = the lane's 32 values of s*g of slab row r: g widened (load_g),
// times s, and on the e4m3 wire times the row's scale gs[r] (fl after each
// product).
template <int W, bool F>
__device__ __forceinline__ void load_row(float* x, const void* __restrict__ g,
                                         const float* __restrict__ gs,
                                         int64_t r, int lane, float s) {
#pragma unroll
  for (int k = 0; k < kRowF4; ++k) {
    const float4 a = load_g<W>(g, f4_index(r, k, lane));
    x[4 * k + 0] = fl<F>(fl<F>(a.x) * s);
    x[4 * k + 1] = fl<F>(fl<F>(a.y) * s);
    x[4 * k + 2] = fl<F>(fl<F>(a.z) * s);
    x[4 * k + 3] = fl<F>(fl<F>(a.w) * s);
  }
  if constexpr (W == kWireE4m3) {
    const float gr = fl<F>(gs[r]);
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) x[j] = fl<F>(x[j] * gr);
  }
}

// One warp per row of the slab; slab row r folds into arena row off + r.
// G: the guarded form (guard is the vector; the unguarded form's code is
// the same with the guard read compiled out). W: g's wire (load_g); gs the
// e4m3 wire's (rows_g, 1) scale column (NULL on the others).
template <int MK, int VK, bool G, int W>
__global__ void __launch_bounds__(kThreads)
arena_fold_kernel(void* __restrict__ m0, void* __restrict__ m1,
                  void* __restrict__ v0, void* __restrict__ v1,
                  const void* __restrict__ g, const float* __restrict__ gs,
                  int64_t off, int64_t rows_g, float s, float c1, float c2,
                  float dm, float dv, const float4* __restrict__ guard) {
  constexpr bool F = MK != kFp32 || VK != kFp32;
  const volatile float* gv = nullptr;
  if constexpr (G) {
    gv = fold_guard(guard);
    if (gv[kGOk] == 0.0f) return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
       r < rows_g; r += warps) {
    float x[kRowVals];
    load_row<W, F>(x, g, gs, r, lane, G ? gv[kGScale] : s);
    fold_moment<MK, false, F, W == kWireE4m3>(m0, m1, x, G ? gv[kGDm] : dm,
                                              c1, off + r, lane);
#pragma unroll
    for (int j = 0; j < kRowVals; ++j) x[j] = fl<F>(x[j] * x[j]);
    fold_moment<VK, true, F>(v0, v1, x, G ? gv[kGDv] : dv, c2, off + r,
                             lane);
  }
}

// Flushed sums of flushed values: add_ftz, which is fl(a + b) for every a
// and b that are zero, normal, Inf or NaN (every caller's).
__device__ __forceinline__ float add1(float a, float b) {
  return add_ftz(a, b);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(add_ftz(a.x, b.x), add_ftz(a.y, b.y), add_ftz(a.z, b.z),
                     add_ftz(a.w, b.w));
}

// A halving tree, x[j] = x[j] + x[j + h] for j < h, h = H, H / 2, ... 1,
// each add flushed; x[0] ends as the sum. Every loop has a constant trip
// count, so the tree unrolls fully and an array in registers stays there:
// written as nested loops (the inner bounded by the outer's h), it left the
// arrays in a local-memory depot that ptxas could not always lift (the
// guarded bf16 int8-m rowcol fold kept a 128-B stack frame, 1.20x slower).
template <int H, typename T>
__device__ __forceinline__ void halving_tree(T* x) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if constexpr (sizeof(T) == sizeof(float4)) x[j] = add4(x[j], x[j + H]);
    else x[j] = add1(x[j], x[j + H]);
  }
  if constexpr (H > 1) halving_tree<H / 2>(x);
}

// The lanes' shuffles down after the halving tree of rowcol_row_sum
__device__ __forceinline__ float lanes_sum(float t) {
  for (int off = 16; off > 0; off >>= 1)
    t = add1(t, __shfl_down_sync(0xffffffffu, t, off));
  return t;
}

// Halving tree over the lane's 32 values, then shuffles down the lanes: the
// row's sum, valid in lane 0. x is overwritten. The plain version
// (fused_step.py::_rowcol_row_sums) takes the same tree.
__device__ __forceinline__ float rowcol_row_sum(float* x) {
  halving_tree<kRowVals / 2>(x);
  return lanes_sum(x[0]);
}

// The int8-m rowcol fold's loads of one row, issued a row ahead: the lane's
// words of g (as load_g reads them), of m's codes, and the row's m scale,
// vr and (e4m3) grad-scale entry.
template <int W>
struct GWord {
  using T = uint32_t;                                      // e4m3: 4 codes
};
template <>
struct GWord<kWireF32> {
  using T = float4;
};
template <>
struct GWord<kWireBf16> {
  using T = uint2;
};

template <int W>
struct RowIn {
  typename GWord<W>::T g[kRowF4];
  uint32_t q[kRowF4];
  float ms, vr, gs;
};

template <int W>
__device__ __forceinline__ void load_in(RowIn<W>& in, const void* g,
                                        const float* gs, const uint32_t* mq,
                                        const float* msc, const float* vr,
                                        int64_t r, int64_t row, int lane) {
  using T = typename GWord<W>::T;
#pragma unroll
  for (int k = 0; k < kRowF4; ++k) {
    in.g[k] = ((const T*)g)[f4_index(r, k, lane)];
    in.q[k] = mq[f4_index(row, k, lane)];
  }
  in.ms = msc[row];
  in.vr = vr[row];
  if constexpr (W == kWireE4m3) in.gs = gs[r];
}

// A loaded word of g as four exact float32 (load_g's widening; e4m3 by
// e4m3x4_to_f32)
template <int W>
__device__ __forceinline__ float4 widen(typename GWord<W>::T w) {
  if constexpr (W == kWireF32) {
    return w;
  } else if constexpr (W == kWireE4m3) {
    return e4m3x4_to_f32(w);
  } else {
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
}

// One row of the int8-m rowcol fold: arena_fold_kernel's arithmetic for m
// (load_row, fold_moment<kInt8>, q8_store) and v = rowcol's (the squares,
// the warp's column partials in `sacc`, the row sum and vr), each
// operation the one it replaces bit for bit (the header's Rounding):
//   x   = fl(fl(g) * s)             ftz(g * s) after ftz(g); e4m3 codes are
//                                   never subnormal, so not flushed
//   x   = fl(x * fl(gs[r]))         (e4m3) ftz(x * ftz(gs[r]))
//   dec = fl(q * fl(ms))            q * ftz(ms): |q| >= 1 and a flushed
//                                   scale give |q * ms| >= 2^-126 or 0
//   y   = fl(fma(c1, x, fl(dm * dec)))   or, on the e4m3 wire,
//         fl(fma(dm, dec, fl(c1 * x)))   each fl an ftz
//   x^2 = fl(x * x)                 mul_ftz(x, x)
//   sums                            add_ftz
// and the codes by q8m_word. The row sum's tree is rowcol_row_sum's; its
// first level is taken as the squares come, pairing float4 k with k + 4.
template <int W>
__device__ __forceinline__ void rowcol_int8_row(
    const RowIn<W>& in, float s, float c1, float dm, float c2, float dv,
    float4* sacc, uint32_t* __restrict__ mq, float* __restrict__ msc,
    float* __restrict__ vr, int64_t row, int lane) {
  const float ms = ftz(in.ms);
  const float gr = W == kWireE4m3 ? ftz(in.gs) : 0.0f;
  float y[kRowVals], t[kRowVals / 2];
  float mx = 0.0f;
#pragma unroll
  for (int h = 0; h < kRowF4 / 2; ++h) {
    float sq[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = h + half * (kRowF4 / 2);
      const float4 a4 = widen<W>(in.g[k]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const uint32_t q = in.q[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = W == kWireE4m3 ? ftz(__fmul_rn(a[e], s))
                                 : ftz(__fmul_rn(ftz(a[e]), s));
        if constexpr (W == kWireE4m3) x = ftz(__fmul_rn(x, gr));
        const float dec = __fmul_rn(
            (float)(signed char)(q >> (8 * e)), ms);
        const float yv =
            W == kWireE4m3
                ? ftz(__fmaf_rn(dm, dec, ftz(__fmul_rn(c1, x))))
                : ftz(__fmaf_rn(c1, x, ftz(__fmul_rn(dm, dec))));
        y[4 * k + e] = yv;
        mx = fmaxf(mx, fabsf(yv));
        sq[half][e] = mul_ftz(x, x);
      }
      float4 acc = sacc[k * 32 + lane];
      acc = add4(acc, make_float4(sq[half][0], sq[half][1], sq[half][2],
                                  sq[half][3]));
      sacc[k * 32 + lane] = acc;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) t[4 * h + e] = add1(sq[0][e], sq[1][e]);
  }
  halving_tree<kRowVals / 4>(t);
  const float rs = lanes_sum(t[0]);
  mx = warp_max(mx);
  const float sc = q8_scale(mx);
  const float sd = sc > 0.0f ? sc : 1.0f;
  if (q8_recip_ok(sd)) q8m_codes<true>(y, sd, mq, row, lane);
  else q8m_codes<false>(y, sd, mq, row, lane);
  if (lane == 0) {
    msc[row] = sc;
    vr[row] = fl<true>(fmaf(dv, fl<true>(in.vr), fl<true>(c2 * rs)));
  }
}

// How many CTAs add the ranges' partials (a power of two, at most
// kOrderedMax, at most `ranges`, and fewer than the CTAs the card holds at
// once: see rowcol_fold_kernel).
constexpr int kOrderedMax = 64;

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The rowcol fold (v = rowcol, every rowcol pair flushes): one CTA per range
// [p * range_rows, min((p + 1) * range_rows, rows_g)) of the slab's rows.
// m folds as in arena_fold_kernel; vr row by row; the column partials as
// the header says, into partials[p]; the CTAs that take the last `ordered`
// tickets add them in order p = 0, 1, ..., each its share of the columns,
// and fold the totals into vc. ticket: an integer the launcher zeroes. G,
// W and gs as in arena_fold_kernel.
template <int MK, bool G, int W>
__global__ void __launch_bounds__(kThreads, 2)
rowcol_fold_kernel(void* __restrict__ m0, void* __restrict__ m1,
                   float* __restrict__ vr, float4* __restrict__ vc,
                   const void* __restrict__ g, const float* __restrict__ gs,
                   int64_t off, int64_t rows_g,
                   int64_t range_rows, int ranges, int ordered,
                   float4* __restrict__ partials,
                   unsigned int* __restrict__ ticket, float s, float c1,
                   float c2, float dm, float dv,
                   const float4* __restrict__ guard) {
  // ok == 0: no CTA writes, so none takes a ticket and vc is never written
  const volatile float* gv = nullptr;
  if constexpr (G) {
    gv = fold_guard(guard);
    if (gv[kGOk] == 0.0f) return;
  }
  // each warp's column partials meet in shared memory (32 KB). A warp
  // accumulates its rows in registers when m is fp32, and in its own row
  // of `red` when m is int8, whose re-encode needs the registers (each
  // lane owns its entries: no barrier until the warps meet). Same order.
  constexpr bool kRegAcc = MK == kFp32;
  __shared__ float4 red[kWarps][kLanes / 4];
  __shared__ unsigned int taken;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int64_t lo = (int64_t)blockIdx.x * range_rows;
  const int64_t hi = lo + range_rows < rows_g ? lo + range_rows : rows_g;
  float4 acc[kRegAcc ? kRowF4 : 1];
  float4* const sacc = red[warp];
#pragma unroll
  for (int k = 0; k < kRowF4; ++k) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kRegAcc) acc[k] = zero;
    else sacc[k * 32 + lane] = zero;
  }
  int64_t r = lo + warp;
  if constexpr (MK == kInt8) {
    // row r's arithmetic runs while row r + 8's loads are in flight
    uint32_t* const mq = (uint32_t*)m0;
    float* const msc = (float*)m1;
    RowIn<W> cur;
    if (r < hi) load_in<W>(cur, g, gs, mq, msc, vr, r, off + r, lane);
    for (; r < hi; r += kWarps) {
      RowIn<W> nxt = cur;
      if (r + kWarps < hi)
        load_in<W>(nxt, g, gs, mq, msc, vr, r + kWarps, off + r + kWarps,
                   lane);
      rowcol_int8_row<W>(cur, G ? gv[kGScale] : s, c1, G ? gv[kGDm] : dm,
                         c2, G ? gv[kGDv] : dv, sacc, mq, msc, vr, off + r,
                         lane);
      cur = nxt;
    }
  } else {
    for (; r < hi; r += kWarps) {
      float x[kRowVals];
      load_row<W, true>(x, g, gs, r, lane, G ? gv[kGScale] : s);
      fold_moment<MK, false, true, W == kWireE4m3>(
          m0, m1, x, G ? gv[kGDm] : dm, c1, off + r, lane);
#pragma unroll
      for (int k = 0; k < kRowF4; ++k) {
        float* e = x + 4 * k;
        e[0] = fl<true>(e[0] * e[0]);
        e[1] = fl<true>(e[1] * e[1]);
        e[2] = fl<true>(e[2] * e[2]);
        e[3] = fl<true>(e[3] * e[3]);
        acc[k] = add4(acc[k], make_float4(e[0], e[1], e[2], e[3]));
      }
      const float rs = rowcol_row_sum(x);
      if (lane == 0)
        vr[off + r] = fl<true>(fmaf(G ? gv[kGDv] : dv, fl<true>(vr[off + r]),
                                    fl<true>(c2 * rs)));
    }
#pragma unroll
    for (int k = 0; k < kRowF4; ++k) sacc[k * 32 + lane] = acc[k];
  }
  __syncthreads();
  // thread t: columns 4t .. 4t + 3, the warps' partials in a halving tree
  const int t = threadIdx.x;
  float4 w[kWarps];
#pragma unroll
  for (int i = 0; i < kWarps; ++i) w[i] = red[i][t];
  halving_tree<kWarps / 2>(w);
  partials[(int64_t)blockIdx.x * (kLanes / 4) + t] = w[0];
  __threadfence();
  __syncthreads();
  if (t == 0) taken = atomicAdd(ticket, 1u);
  __syncthreads();
  // The CTAs that took the last `ordered` tickets wait until every CTA has
  // taken one (so every range's partials are written), then each adds the
  // ranges' partials of its 256 / ordered float4 columns in order p = 0, 1,
  // .... Waiting is safe: a CTA waits only once it holds one of the last
  // `ordered` tickets, so at most `ordered` CTAs wait at a time, and the
  // launcher keeps `ordered` below the CTAs the card holds at once, so a
  // slot is always free for a CTA that has not yet run.
  const unsigned int first = (unsigned int)(ranges - ordered);
  if (taken < first) return;
  if (t == 0)
    while (ld_acquire(ticket) < (unsigned int)ranges) __nanosleep(100);
  __syncthreads();
  __threadfence();
  // the share's partials pass through `red` in batches of kStage float4
  // (batch_rows ranges of the share's nf floats), the next batch's loads
  // in flight while the current one is added; thread t adds the columns
  // t, t + 256, ... of the share, each a chain over p in order
  constexpr int kStage = kWarps * (kLanes / 4);
  constexpr int kPer = kStage / kThreads;
  const int cols = (kLanes / 4) / ordered, nf = 4 * cols;
  const int batch_rows = kStage / cols;
  const int col0 = (int)(taken - first) * cols;
  float4* const stage = &red[0][0];
  const float* const stage_f = (const float*)stage;
  float4 nx[kPer];
  auto fetch = [&](int p0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + i * kThreads, p = p0 + e / cols;
      nx[i] = p < ranges ? __ldcg(&partials[(int64_t)p * (kLanes / 4) + col0 +
                                            e % cols])
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  fetch(0);
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int p0 = 0; p0 < ranges; p0 += batch_rows) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) stage[t + i * kThreads] = nx[i];
    __syncthreads();
    if (p0 + batch_rows < ranges) fetch(p0 + batch_rows);
    const int n = ranges - p0 < batch_rows ? ranges - p0 : batch_rows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = t + j * kThreads;
      if (f >= nf) break;
      int i = 0;
      if (p0 == 0) sum[j] = stage_f[f], i = 1;
#pragma unroll 16
      for (; i < n; ++i) sum[j] = add1(sum[j], stage_f[i * nf + f]);
    }
  }
  float* const vcf = (float*)vc + 4 * col0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = t + j * kThreads;
    if (f >= nf) break;
    vcf[f] = fl<true>(fmaf(c2, sum[j], fl<true>(vcf[f])));
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
  const float f = fl<true>(((const float*)c0)[row]);
  if constexpr (K == kFactored) return make_float4(f, f, f, f);
  // rowcol: c1 is the CTA's vc / max(sum(vc), 1e-30) in shared memory
  const float4 n = ((const float4*)c1)[k * 32 + lane];
  return make_float4(fl<true>(f * n.x), fl<true>(f * n.y), fl<true>(f * n.z),
                     fl<true>(f * n.w));
}

// Rowcol's normalised column sums vc / max(sum(vc), 1e-30), into `nc`
// (shared memory), by every CTA alike. The sum's tree: thread t's four
// columns 4t .. 4t + 3 as (a.x + a.z) + (a.y + a.w), shuffles down each
// warp's lanes, then a halving tree over the 8 warps; the plain version
// (adama_accum.py::rowcol_total) takes the same one.
__device__ __forceinline__ void rowcol_normalise(const float4* __restrict__ vc,
                                                 float4* nc) {
  __shared__ float ws[kWarps];
  __shared__ float total;
  const int t = threadIdx.x, lane = t & 31;
  float4 a = vc[t];
  a = make_float4(fl<true>(a.x), fl<true>(a.y), fl<true>(a.z), fl<true>(a.w));
  float x = fl<true>(fl<true>(a.x + a.z) + fl<true>(a.y + a.w));
  for (int off = 16; off > 0; off >>= 1)
    x = fl<true>(x + __shfl_down_sync(0xffffffffu, x, off));
  if (lane == 0) ws[t / 32] = x;
  __syncthreads();
  if (t == 0) {
    halving_tree<kWarps / 2>(ws);
    total = fmaxf(ws[0], kRcFloor);
  }
  __syncthreads();
  nc[t] = make_float4(fl<true>(a.x / total), fl<true>(a.y / total),
                      fl<true>(a.z / total), fl<true>(a.w / total));
  __syncthreads();
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

// Four fp32 values rounded to bf16 (nearest even) as one 8-byte word:
// element e in bits 16e .. 16e + 15 of the little-endian word (load_g's
// layout of the bf16 wire).
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint2 bf16x4(float4 a) {
  return make_uint2(bf16_bits(a.x) | (bf16_bits(a.y) << 16),
                    bf16_bits(a.z) | (bf16_bits(a.w) << 16));
}

// E: the master form (work is the bf16 output, NULL otherwise). G as in
// arena_fold_kernel; with ok == 0 the plain form returns before any write,
// the master form writes work = bf16(p) and leaves p.
template <int MK, int VK, bool G, bool E>
__global__ void __launch_bounds__(kThreads)
arena_apply_kernel(float4* __restrict__ p, uint2* __restrict__ work,
                   const void* __restrict__ m0, const void* __restrict__ m1,
                   const void* __restrict__ v0, const void* v1, int64_t rows,
                   float lr, float bc1, float bc2, float eps, float wd,
                   const float* __restrict__ guard) {
  constexpr bool F = MK != kFp32 || VK != kFp32;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  if constexpr (G) {
    if (!apply_guard(guard)) {
      if constexpr (E) {
        for (int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
             r < rows; r += warps) {
#pragma unroll
          for (int k = 0; k < kRowF4; ++k)
            work[f4_index(r, k, lane)] = bf16x4(p[f4_index(r, k, lane)]);
        }
      }
      return;
    }
  }
  __shared__ float4 nc[VK == kRowCol ? kLanes / 4 : 1];
  if constexpr (VK == kRowCol) {
    rowcol_normalise((const float4*)v1, nc);
    v1 = nc;
  }
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
      if constexpr (E) work[f4_index(r, k, lane)] = bf16x4(pp);
    }
  }
}

// finite_and: an Inf or NaN has every exponent bit set (fp32 0x7f800000, bf16
// 0x7f80), so the check is integer arithmetic on the raw bits. B is the
// element's bytes (4 fp32, 2 bf16).
template <int B>
__device__ __forceinline__ bool nonfinite_elem(const unsigned char* p) {
  if constexpr (B == 4)
    return (*(const uint32_t*)p & 0x7f800000u) == 0x7f800000u;
  else
    return (*(const uint16_t*)p & 0x7f80u) == 0x7f80u;
}

// 16 bytes: 4 fp32, or 8 bf16 (two to a 32-bit word, each half checked)
template <int B>
__device__ __forceinline__ bool nonfinite16(uint4 w) {
  constexpr uint32_t hi = 0x7f800000u, lo = 0x7f80u;
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bad |= (u[i] & hi) == hi;
    if constexpr (B == 2) bad |= (u[i] & lo) == lo;
  }
  return bad;
}

// One pass over x: elements [0, head) come before the 16-byte-aligned body
// of n16 words, `tail` elements after it. A grid-stride loop keeps 4 words
// in flight per thread; block 0's first warp checks the head and the tail.
// A warp that saw a non-finite element stores 0.0f into ok (never a read of
// ok, never another value), so ok ends as ok AND finite(x).
template <int B>
__global__ void __launch_bounds__(kThreads)
finite_and_kernel(const unsigned char* __restrict__ x, int64_t head,
                  int64_t n16, int64_t tail, float* __restrict__ ok) {
  const uint4* body = (const uint4*)(x + head * B);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool bad = false;
  for (; i + 3 * stride < n16; i += 4 * stride) {
    uint4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = body[i + k * stride];
#pragma unroll
    for (int k = 0; k < 4; ++k) bad |= nonfinite16<B>(w[k]);
  }
  for (; i < n16; i += stride) bad |= nonfinite16<B>(body[i]);
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    for (int64_t e = threadIdx.x; e < head; e += 32)
      bad |= nonfinite_elem<B>(x + e * B);
    const unsigned char* t = x + (head + n16 * (16 / B)) * B;
    for (int64_t e = threadIdx.x; e < tail; e += 32)
      bad |= nonfinite_elem<B>(t + e * B);
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *ok = 0.0f;
}

// fold_exactness: each substitution of the rowcol fold's int8 m design
// against the expression it replaces, on the card, bit for bit. Check C
// maps an index i in [0, x_count(C)) to its inputs and returns how many
// results it compared; NaN results compare as NaN (their payloads may
// differ: counted apart).
enum XCheck {
  kXDecode = 0,   // the pair decode vs e4m3_to_f32: all 2^16 code pairs
  kXFlush = 1,    // ftz(x) vs fl(x): all 2^32 bit patterns
  kXAdd = 2,      // add_ftz vs fl(fl a + fl b): sums around +-2^-126
  kXSquare = 3,   // mul_ftz(x, x) vs fl(fl x * fl x): all 2^32 x
  kXMul = 4,      // mul_ftz vs fl(fl a * fl b): products around +-2^-126
  kXFma = 5,      // fma_ftz vs fl(fma(fl a, fl b, fl c)): around +-2^-126
                  // (these two part: the kernels do not use them)
  kXQuot = 6,     // q8 m codes through the reciprocal vs the divide
  kXChecks = 7
};

// kXQuot's grid of divisors: sd = 2^e * (1 + m 2^-23) for e in kXQuotExp and
// 64 mantissas (8 fixed, 56 hashed), and sd = Inf. For each, x is every
// float of the 9 binades [2^(e - 1), 2^(e + 8)) (every quotient from 1/4 up
// past 128), then 2^16 more: zeros, subnormals, 2^-126, NaN (and Inf for
// sd = Inf: a row holding an Inf has an Inf max, so no finite sd meets
// one) and hashed |x| below sd / 2. Then kXQuotMax row maxima mx (hashed
// over every binade) with sd = the scale q8_scale gives them (1 if it is
// 0) and x = mx - d ulps, d < 8. Each x goes into one word of four codes
// with -x, its neighbour and the neighbour's negation.
__constant__ int kXQuotExp[] = {-126, -125, -124, -120, -110, -104, -103,
                                -102, -100, -80,  -40,  -10,  -1,   0,
                                1,    10,   40,   80,   100,  120,  121};
constexpr int kXQuotExps = 21;
constexpr int kXQuotMants = 64;
constexpr uint64_t kXQuotExhaustive = 9ull << 23;
constexpr uint64_t kXQuotPerSd = kXQuotExhaustive + (1ull << 16);
constexpr uint64_t kXQuotSds = (uint64_t)(kXQuotExps + 1) * kXQuotMants;
constexpr uint64_t kXQuotMax = 1ull << 26;

__host__ __device__ constexpr uint64_t x_count(int c) {
  return c == kXDecode   ? 1ull << 16
         : c == kXFlush  ? 1ull << 32
         : c == kXAdd    ? 1ull << 28
         : c == kXSquare ? 1ull << 32
         : c == kXMul    ? 1ull << 31
         : c == kXFma    ? 1ull << 30
                         : kXQuotSds * kXQuotPerSd + kXQuotMax * 8;
}

__device__ __forceinline__ uint32_t mix32(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return (uint32_t)x;
}

__device__ __forceinline__ float fbits(uint32_t u) {
  return __uint_as_float(u);
}

// a random normal float: exponent field in [lo, lo + span), any mantissa
__device__ __forceinline__ float rand_normal(uint32_t h, uint32_t lo,
                                             uint32_t span) {
  return fbits((h & 0x80000000u) | ((lo + (h >> 23) % span) << 23) |
               (h & 0x7fffffu));
}

__device__ __forceinline__ int x_quot(uint64_t i, float* got, float* want) {
  float sd, x;
  if (i < kXQuotSds * kXQuotPerSd) {
    const uint64_t sdi = i / kXQuotPerSd, xi = i % kXQuotPerSd;
    const int ei = (int)(sdi / kXQuotMants), mi = (int)(sdi % kXQuotMants);
    constexpr uint32_t kFixed[8] = {0u, 1u, 0x7fffffu, 0x400000u, 0x555555u,
                                    0x2aaaabu, 0x7ffffeu, 0x000f00u};
    const uint32_t mant = mi < 8 ? kFixed[mi] : mix32(sdi) & 0x7fffffu;
    const int e = ei < kXQuotExps ? kXQuotExp[ei] : 128;
    sd = fbits(e == 128 ? 0x7f800000u : ((uint32_t)(e + 127) << 23) | mant);
    if (xi < kXQuotExhaustive) {
      if (e == 128) return 0;               // no binades below Inf
      const int ex = e - 1 + (int)(xi >> 23);
      if (ex > 127) return 0;
      const uint32_t m = (uint32_t)(xi & 0x7fffff);
      x = fbits(ex >= -126 ? ((uint32_t)(ex + 127) << 23) | m
                           : (m | 0x800000u) >> (-126 - ex));
    } else {
      const uint32_t k = (uint32_t)(xi - kXQuotExhaustive);
      constexpr uint32_t kEdge[10] = {0u,          0x80000000u, 1u,
                                      0x80000001u, 0x00800000u, 0x80800000u,
                                      0x007fffffu, 0x7f800000u, 0xff800000u,
                                      0x7fc00000u};
      if (k < 10) {
        if (e != 128 && (k == 7 || k == 8)) return 0;
        x = fbits(kEdge[k]);
      } else {
        const uint32_t h = mix32(i);
        const int top = e == 128 ? 254 : e > -125 ? e + 126 : 1;
        x = fbits((h & 0x80000000u) | ((h >> 23) % (uint32_t)top) << 23 |
                  (h & 0x7fffffu));
      }
    }
  } else {
    const uint64_t j = i - kXQuotSds * kXQuotPerSd;
    const float mx = fabsf(rand_normal(mix32(j >> 3), 1, 254));
    const float s = q8_scale(mx);
    sd = s > 0.0f ? s : 1.0f;
    x = fbits(__float_as_uint(mx) - (uint32_t)(j & 7));
  }
  // x, -x and the next float away from zero (toward it from the largest
  // finite float) and its negation, as one word
  const uint32_t bx = __float_as_uint(x);
  const float x1 = fbits(bx == 0x7f7fffffu ? bx - 1u : bx + 1u);
  const float4 x4 = make_float4(x, -x, x1, -x1);
  const float r = __frcp_rn(sd);
  const uint32_t w = q8_recip_ok(sd) ? q8m_word<true>(x4, sd, r)
                                     : q8m_word<false>(x4, sd, r);
  const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    got[j] = (float)(signed char)(w >> (8 * j));
    want[j] = (float)q8_code_m_div(xs[j], sd);
  }
  return 4;
}

template <int C>
__device__ __forceinline__ int x_case(uint64_t i, float* got, float* want) {
  if constexpr (C == kXDecode) {
    const uint32_t c = (uint32_t)i;
    const float4 a = e4m3x4_to_f32(c | (c << 16));
    got[0] = a.x, got[1] = a.y, got[2] = a.z, got[3] = a.w;
    want[0] = want[2] = e4m3_to_f32(c & 0xffu);
    want[1] = want[3] = e4m3_to_f32(c >> 8);
    return 4;
  } else if constexpr (C == kXFlush) {
    const float x = fbits((uint32_t)i);
    got[0] = ftz(x), want[0] = fl<true>(x);
  } else if constexpr (C == kXSquare) {
    const float x = fbits((uint32_t)i);
    got[0] = mul_ftz(x, x);
    want[0] = fl<true>(__fmul_rn(fl<true>(x), fl<true>(x)));
  } else if constexpr (C == kXAdd) {
    // 4 classes x both signs x 2^12 x 2^12: both just above 2^-126; a up
    // to 2^-125 and b subnormal; a above 2^-125 and b between; both
    // subnormal
    const uint32_t ma = i & 0xfff, mb = (i >> 12) & 0xfff;
    uint32_t a, b;
    switch ((i >> 26) & 3) {
      case 0: a = 0x800000u + ma, b = 0x800000u + mb; break;
      case 1: a = 0x800000u + (ma << 11), b = mb; break;
      case 2: a = 0x1000000u + ma, b = 0x800000u + (mb << 11); break;
      default: a = (ma << 11) | ma, b = mb; break;
    }
    const float fa = fbits(a | (uint32_t)((i >> 24) & 1) << 31);
    const float fb = fbits(b | (uint32_t)((i >> 25) & 1) << 31);
    got[0] = add_ftz(fa, fb);
    want[0] = fl<true>(__fadd_rn(fl<true>(fa), fl<true>(fb)));
  } else if constexpr (C == kXMul) {
    float fa, fb;
    if (i < (1ull << 30)) {
      // a = 2^-t, t = 1 .. 32; b over the two binades that put a * b in
      // [2^-127, 2^-125), every mantissa, both signs: every rounding
      // position below 2^-126, ties included
      const uint32_t t = 1 + (uint32_t)(i >> 25);
      fa = fbits((127u - t) << 23);
      fb = fbits(((uint32_t)(i >> 24) & 1) << 31 |
                 (t + (uint32_t)((i >> 23) & 1)) << 23 |
                 (uint32_t)(i & 0x7fffff));
    } else {
      // a any mantissa, exponent in [-62, 0]; b within 128 ulps of
      // 2^-126 / a
      const uint32_t h = mix32(i >> 8);
      fa = rand_normal(h, 65, 63);
      const float b0 = fabsf(__fdiv_rn(kTiny, fa));
      fb = fbits((__float_as_uint(b0) + (uint32_t)(i & 0xff) - 128u) |
                 (mix32(i) & 0x80000000u));
    }
    got[0] = mul_ftz(fa, fb);
    want[0] = fl<true>(__fmul_rn(fl<true>(fa), fl<true>(fb)));
  } else if constexpr (C == kXFma) {
    // c in +-[2^-125, 2^-124), a any mantissa, exponent in [-40, 0], b
    // within 128 ulps of (+-2^-126 - c) / a: results around +-2^-126
    const uint32_t h = mix32(i >> 8), h2 = mix32((i >> 8) ^ 0x9e3779b9ull);
    const float fc = rand_normal(h2, 2, 1);
    const float fa = rand_normal(h, 87, 41);
    const float t = copysignf(kTiny, (h2 & 1u) ? 1.0f : -1.0f);
    const float b0 = __fdiv_rn(__fsub_rn(t, fc), fa);
    const float fb = fbits(__float_as_uint(b0) + (uint32_t)(i & 0xff) - 128u);
    got[0] = fma_ftz(fa, fb, fc);
    want[0] = fl<true>(__fmaf_rn(fl<true>(fa), fl<true>(fb), fl<true>(fc)));
  } else {
    return x_quot(i, got, want);
  }
  return 1;
}

// counts: [inputs compared, differing, NaN payloads differing, least
// differing index]
template <int C>
__global__ void __launch_bounds__(kThreads)
fold_exactness_kernel(unsigned long long* __restrict__ counts) {
  constexpr uint64_t n = x_count(C);
  unsigned long long cov = 0, bad = 0, nanp = 0, first = ~0ull;
  for (uint64_t i = (uint64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * kThreads) {
    float got[4], want[4];
    const int k = x_case<C>(i, got, want);
    for (int j = 0; j < k; ++j) {
      if (__float_as_uint(got[j]) == __float_as_uint(want[j])) continue;
      if (got[j] != got[j] && want[j] != want[j]) {
        ++nanp;
      } else {
        ++bad;
        first = first < i ? first : i;
      }
    }
    cov += k;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cov += __shfl_xor_sync(0xffffffffu, cov, off);
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
    nanp += __shfl_xor_sync(0xffffffffu, nanp, off);
    const unsigned long long f = __shfl_xor_sync(0xffffffffu, first, off);
    first = f < first ? f : first;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counts[0], cov);
    if (bad) atomicAdd(&counts[1], bad);
    if (nanp) atomicAdd(&counts[2], nanp);
    if (bad) atomicMin(&counts[3], first);
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

// The CTAs of a rowcol fold that add the ranges' partials: the largest
// power of two that is at most kOrderedMax and `ranges`, and below the
// number of the kernel's CTAs the card holds at once (its SMs times the
// CTAs an SM fits), so that the waiting ones never hold every slot.
int rowcol_ordered(const void* kernel, int ranges) {
  int device = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  int k = 1;
  while (2 * k <= kOrderedMax && 2 * k <= ranges && 2 * k < resident) k *= 2;
  return k;
}

// The launch of one pair's fold on one wire. Rowcol takes one CTA per
// range and the (ranges, 1024) fp32 scratch, its ticket right after it; the
// others a grid of rows_grid and no scratch.
template <int MK, int VK, int W>
cudaError_t fold_wire(void* m0, void* m1, void* v0, void* v1, const void* g,
                      const float* gs, int64_t off, int64_t rows_g,
                      int64_t ranges,
                      int64_t range_rows, void* scratch, float s, float c1,
                      float c2, float dm, float dv, const float4* guard,
                      cudaStream_t stream) {
  if constexpr (VK != kRowCol) {
    const int grid = rows_grid(rows_g);
    if (guard == nullptr)
      arena_fold_kernel<MK, VK, false, W><<<grid, kThreads, 0, stream>>>(
          m0, m1, v0, v1, g, gs, off, rows_g, s, c1, c2, dm, dv, nullptr);
    else
      arena_fold_kernel<MK, VK, true, W><<<grid, kThreads, 0, stream>>>(
          m0, m1, v0, v1, g, gs, off, rows_g, s, c1, c2, dm, dv, guard);
    return cudaSuccess;
  } else {
    if (ranges < 1 || ranges > 65535 || range_rows < 1 ||
        scratch == nullptr || (ranges - 1) * range_rows >= rows_g ||
        ranges * range_rows < rows_g)
      return cudaErrorInvalidValue;
    float4* partials = (float4*)scratch;
    unsigned int* ticket = (unsigned int*)(partials + ranges * (kLanes / 4));
    const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int),
                                            stream);
    if (err != cudaSuccess) return err;
    const bool guarded = guard != nullptr;
    const auto kernel = guarded ? rowcol_fold_kernel<MK, true, W>
                                : rowcol_fold_kernel<MK, false, W>;
    kernel<<<(int)ranges, kThreads, 0, stream>>>(
        m0, m1, (float*)v0, (float4*)v1, g, gs, off, rows_g, range_rows,
        (int)ranges, rowcol_ordered((const void*)kernel, (int)ranges),
        partials, ticket, s, c1, c2, dm, dv, guard);
    return cudaSuccess;
  }
}

// One pair's fold on g's wire (kWireF32, kWireBf16; kWireE4m3 with its
// scale column gs, which only that wire takes).
template <int MK, int VK>
cudaError_t fold(int wire, void* m0, void* m1, void* v0, void* v1,
                 const void* g, const float* gs, int64_t off, int64_t rows_g,
                 int64_t ranges, int64_t range_rows, void* scratch, float s,
                 float c1, float c2, float dm, float dv, const float4* guard,
                 cudaStream_t stream) {
  if ((wire == kWireE4m3) != (gs != nullptr)) return cudaErrorInvalidValue;
  if (wire == kWireF32)
    return fold_wire<MK, VK, kWireF32>(m0, m1, v0, v1, g, gs, off, rows_g,
                                       ranges, range_rows, scratch, s, c1,
                                       c2, dm, dv, guard, stream);
  if (wire == kWireBf16)
    return fold_wire<MK, VK, kWireBf16>(m0, m1, v0, v1, g, gs, off, rows_g,
                                        ranges, range_rows, scratch, s, c1,
                                        c2, dm, dv, guard, stream);
  if (wire == kWireE4m3)
    return fold_wire<MK, VK, kWireE4m3>(m0, m1, v0, v1, g, gs, off, rows_g,
                                        ranges, range_rows, scratch, s, c1,
                                        c2, dm, dv, guard, stream);
  return cudaErrorInvalidValue;
}

// One pair's apply, guarded or not (guard NULL), in its plain or master
// form (E: work non-NULL).
template <int MK, int VK, bool E>
void apply_form(void* p, void* work, const void* m0, const void* m1,
                const void* v0, const void* v1, int64_t rows, float lr,
                float bc1, float bc2, float eps, float wd, const float* guard,
                cudaStream_t stream) {
  const int grid = rows_grid(rows);
  if (guard == nullptr)
    arena_apply_kernel<MK, VK, false, E><<<grid, kThreads, 0, stream>>>(
        (float4*)p, (uint2*)work, m0, m1, v0, v1, rows, lr, bc1, bc2, eps,
        wd, nullptr);
  else
    arena_apply_kernel<MK, VK, true, E><<<grid, kThreads, 0, stream>>>(
        (float4*)p, (uint2*)work, m0, m1, v0, v1, rows, lr, bc1, bc2, eps,
        wd, guard);
}

template <int MK, int VK>
void apply(void* p, void* work, const void* m0, const void* m1,
           const void* v0, const void* v1, int64_t rows, float lr, float bc1,
           float bc2, float eps, float wd, const float* guard,
           cudaStream_t stream) {
  if (work == nullptr)
    apply_form<MK, VK, false>(p, work, m0, m1, v0, v1, rows, lr, bc1, bc2,
                              eps, wd, guard, stream);
  else
    apply_form<MK, VK, true>(p, work, m0, m1, v0, v1, rows, lr, bc1, bc2,
                             eps, wd, guard, stream);
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes). mk: m's kind (0
// fp32, 1 int8); vk: v's (0 fp32, 1 int8, 2 factored, 3 rowcol). m0/m1 and
// v0/v1 are each moment's columns over the whole arena (the second NULL for
// a one-column codec; rowcol's v1 is its (1, 1024) column sums); every
// pointer is 16-byte aligned (the Python wrappers check it). Each returns
// cudaGetLastError() after the launch, so a refused launch or an unknown
// pair surfaces as a non-zero code.
#define PAIRS(X)                                                         \
  X(kFp32, kFp32) X(kFp32, kInt8) X(kFp32, kFactored) X(kFp32, kRowCol) \
  X(kInt8, kFp32) X(kInt8, kInt8) X(kInt8, kFactored) X(kInt8, kRowCol)

// g is the (rows_g, 1024) slab for arena rows [row_offset, row_offset +
// rows_g), inside the arena (checked by the wrapper), of fp32 (wire 0), bf16
// (wire 1) or e4m3 (wire 2) elements; the whole-arena fold passes
// row_offset 0 and rows_g = the arena's rows. ranges, range_rows and
// scratch serve rowcol alone (rowcol_partition(rows_g) and a (ranges * 1024
// + 4)-float buffer; 0, 0 and NULL for the other pairs). The guarded
// launcher takes one more argument, the 16-byte-aligned device vector [dm,
// dv, ok, s], whose values replace s, dm and dv; the unguarded one passes
// NULL to the same kernels. The e4m3 wire's launchers (arena_fold_e4m3_*)
// take the same arguments and then grad_scale, the slab's (rows_g, 1) fp32
// scale column, before the guard; the others refuse wire 2.
namespace {
int fold_dispatch(int mk, int vk, void* m0, void* m1, void* v0, void* v1,
                  const void* g, int wire, const void* gs, int64_t row_offset,
                  int64_t rows_g, int64_t ranges, int64_t range_rows,
                  void* scratch, float s, float c1, float c2, float dm,
                  float dv, const void* guard, cudaStream_t st) {
  cudaError_t err;
  switch (mk * kVKinds + vk) {
#define FOLD(MK, VK)                                                     \
  case MK * kVKinds + VK:                                                \
    err = fold<MK, VK>(wire, m0, m1, v0, v1, g, (const float*)gs,        \
                       row_offset, rows_g, ranges, range_rows, scratch,  \
                       s, c1, c2, dm, dv, (const float4*)guard, st);     \
    break;
    PAIRS(FOLD)
#undef FOLD
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int apply_dispatch(int mk, int vk, void* p, void* work, const void* m0,
                   const void* m1, const void* v0, const void* v1,
                   int64_t rows, float lr, float bc1, float bc2, float eps,
                   float wd, const void* guard, cudaStream_t st) {
  switch (mk * kVKinds + vk) {
#define APPLY(MK, VK)                                                   \
  case MK * kVKinds + VK:                                               \
    apply<MK, VK>(p, work, m0, m1, v0, v1, rows, lr, bc1, bc2, eps, wd, \
                  (const float*)guard, st);                             \
    break;
    PAIRS(APPLY)
#undef APPLY
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int arena_fold_launch(int mk, int vk, void* m0, void* m1,
                                 void* v0, void* v1, const void* g, int wire,
                                 int64_t row_offset, int64_t rows_g,
                                 int64_t ranges, int64_t range_rows,
                                 void* scratch, float s, float c1, float c2,
                                 float dm, float dv, void* stream) {
  return fold_dispatch(mk, vk, m0, m1, v0, v1, g, wire, nullptr, row_offset,
                       rows_g, ranges, range_rows, scratch, s, c1, c2, dm,
                       dv, nullptr, (cudaStream_t)stream);
}

extern "C" int arena_fold_guarded_launch(int mk, int vk, void* m0, void* m1,
                                         void* v0, void* v1, const void* g,
                                         int wire, int64_t row_offset,
                                         int64_t rows_g, int64_t ranges,
                                         int64_t range_rows, void* scratch,
                                         float s, float c1, float c2,
                                         float dm, float dv,
                                         const void* guard, void* stream) {
  if (guard == nullptr) return (int)cudaErrorInvalidValue;
  return fold_dispatch(mk, vk, m0, m1, v0, v1, g, wire, nullptr, row_offset,
                       rows_g, ranges, range_rows, scratch, s, c1, c2, dm,
                       dv, guard, (cudaStream_t)stream);
}

extern "C" int arena_fold_e4m3_launch(int mk, int vk, void* m0, void* m1,
                                      void* v0, void* v1, const void* g,
                                      int wire, int64_t row_offset,
                                      int64_t rows_g, int64_t ranges,
                                      int64_t range_rows, void* scratch,
                                      float s, float c1, float c2, float dm,
                                      float dv, const void* grad_scale,
                                      void* stream) {
  if (grad_scale == nullptr) return (int)cudaErrorInvalidValue;
  return fold_dispatch(mk, vk, m0, m1, v0, v1, g, wire, grad_scale,
                       row_offset, rows_g, ranges, range_rows, scratch, s,
                       c1, c2, dm, dv, nullptr, (cudaStream_t)stream);
}

extern "C" int arena_fold_e4m3_guarded_launch(
    int mk, int vk, void* m0, void* m1, void* v0, void* v1, const void* g,
    int wire, int64_t row_offset, int64_t rows_g, int64_t ranges,
    int64_t range_rows, void* scratch, float s, float c1, float c2, float dm,
    float dv, const void* grad_scale, const void* guard, void* stream) {
  if (grad_scale == nullptr || guard == nullptr)
    return (int)cudaErrorInvalidValue;
  return fold_dispatch(mk, vk, m0, m1, v0, v1, g, wire, grad_scale,
                       row_offset, rows_g, ranges, range_rows, scratch, s,
                       c1, c2, dm, dv, guard, (cudaStream_t)stream);
}

// The apply: p (the fp32 arena, or the master) and then work, the
// (rows, 1024) bf16 working-param output of the master form, or NULL for
// the plain form. The guarded apply's extra argument: the device float ok
// (0 leaves p untouched; the master form still writes work = bf16(p)).
extern "C" int arena_apply_launch(int mk, int vk, void* p, void* work,
                                  const void* m0, const void* m1,
                                  const void* v0, const void* v1,
                                  int64_t rows, float lr, float bc1,
                                  float bc2, float eps, float wd,
                                  void* stream) {
  return apply_dispatch(mk, vk, p, work, m0, m1, v0, v1, rows, lr, bc1, bc2,
                        eps, wd, nullptr, (cudaStream_t)stream);
}

extern "C" int arena_apply_guarded_launch(int mk, int vk, void* p,
                                          void* work, const void* m0,
                                          const void* m1, const void* v0,
                                          const void* v1, int64_t rows,
                                          float lr, float bc1, float bc2,
                                          float eps, float wd,
                                          const void* guard, void* stream) {
  if (guard == nullptr) return (int)cudaErrorInvalidValue;
  return apply_dispatch(mk, vk, p, work, m0, m1, v0, v1, rows, lr, bc1, bc2,
                        eps, wd, guard, (cudaStream_t)stream);
}

// x: the tensor's first byte; elem_bytes 4 (fp32) or 2 (bf16); head, n16 and
// tail as finite_and_kernel takes them (the wrapper splits the tensor at its
// 16-byte-aligned body); ok: a device float.
extern "C" int finite_and_launch(const void* x, int elem_bytes, int64_t head,
                                 int64_t n16, int64_t tail, void* ok,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n16 + 4 * kThreads - 1) / (4 * kThreads);
  const int64_t cap = (int64_t)sms * kWavesPerSm;
  const int blocks = (int)(want < 1 ? 1 : want < cap ? want : cap);
  const unsigned char* xb = (const unsigned char*)x;
  if (elem_bytes == 4)
    finite_and_kernel<4><<<blocks, kThreads, 0, st>>>(xb, head, n16, tail,
                                                      (float*)ok);
  else if (elem_bytes == 2)
    finite_and_kernel<2><<<blocks, kThreads, 0, st>>>(xb, head, n16, tail,
                                                      (float*)ok);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// check: an XCheck; counts: 4 unsigned 64-bit integers on the card, set by
// the caller to [0, 0, 0, ~0] (fold_exactness_kernel adds into them).
extern "C" int fold_exactness_launch(int check, void* counts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = sms * kWavesPerSm;
  unsigned long long* c = (unsigned long long*)counts;
  switch (check) {
#define XCHECK(C) \
  case C: fold_exactness_kernel<C><<<blocks, kThreads, 0, st>>>(c); break;
    XCHECK(kXDecode) XCHECK(kXFlush) XCHECK(kXAdd) XCHECK(kXSquare)
    XCHECK(kXMul) XCHECK(kXFma) XCHECK(kXQuot)
#undef XCHECK
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
