// RWKV-6 chunked time-mix scan for Hopper (sm_90a): forward and backward.
//
// The forward replaces repro/kernels/rwkv6_chunk.py::rwkv6_chunk_scan (the
// Pallas kernel _kernel, grid (BH, n_chunks) with the (K, V) state resident
// across chunks). The backward is its gradient, which the reference leaves
// to XLA's differentiation of the model's jnp scan. fp32 in and out.
//
// Per head and chunk of C tokens (cw / cx the inclusive / exclusive cumsum
// of logw over the chunk, T = cw[C-1]):
//   y[t]   = (r[t] e^{cx[t]}) S + sum_{i<t} A[t,i] v[i] + (r[t].u.k[t]) v[t]
//   A[t,i] = sum_k r[t,k] k[i,k] e^{cx[t,k] - cw[i,k]}
//   S'     = diag(e^T) S + sum_i (k[i] e^{T - cw[i]})^T v[i]
//
// Overflow. logw reaches -e^8 per token in the model, so e^{-cw} overflows
// within a chunk: no exponential here is split into e^{cx} * e^{-cw} over a
// chunk. Each is taken of a difference that is <= 0 (up to the cumsums'
// rounding), or, in the forward's factored blocks, of two such differences
// (see pass 2). The TPU kernel materialises the (C, C, K) pairwise decay (1
// MB at C = K = 64, more than the 227 KB a CTA may use); no kernel here
// does. For the same reason the backward does not rebuild S from S' by
// dividing by e^T: the forward writes the state at the start of every chunk
// (`states`, BH x n_chunks x K x V) and the backward reads it.
//
// Forward: two launches. Only S' needs the carried state, and of y only
// (r e^{cx}) S does. Pass 1, the state pass, is the only sequential part:
// one CTA per bh walks its chunks with the state in tensor-core
// accumulators, writing each chunk-start state. Pass 2, the output pass,
// runs one CTA per (bh, chunk), all independent, with the pairwise work on
// 16-token sub-chunks and every product on tensor cores (3xTF32, fp32's
// accuracy). It replaced a forward of one CTA per bh that walked its chunks
// with every product in scalar fp32 loops and every pair decay formed
// pairwise: its time was one CTA's latency per chunk times the chunks
// (8.5 ms at BH 128, S 4096), with the card nearly idle.
//
// Backward: three launches. Of the gradient, only dS, the gradient of the
// state at each chunk boundary, needs the chain of chunks: dS_c =
// diag(e^{T_c}) dS_{c+1} + (r e^{cx})^T dy_c, from dS_n = ds_final. It is
// the forward's state recurrence with r e^{cx} (exponent <= 0) for
// k e^{T-cw} and dy for v, over the chunks in reverse, so pass 1 is the
// forward's state kernel instantiated in that direction: it writes dS_{c+1}
// to `dstates` at c and dS_0 to ds0. Given S_c and dS_{c+1}, a chunk's
// gradients depend on that chunk alone. Pass 2, the gradient pass, runs one
// CTA per (bh, chunk), all independent, two per SM, in scalar fp32 with each
// pair decay formed pairwise where it is summed; it writes dr, dk, dv, dlogw
// and the chunk's partial of du. Pass 3 sums the partials in chunk order
// (no atomics: every run gives the same du). They replaced one CTA per bh
// that walked its chunks in reverse, its time one CTA's latency per chunk
// times the chunks (10.3 ms at BH 128, S 4096 on an H100 SXM, 128 of its
// 132 SMs busy); the split runs in 5.7 ms there, pass 1 0.38 ms and pass
// 2 5.3 ms of it.
//
// Bounds at the rwkv6-7b training shape (BH 128, S 4096, K = V = C = 64),
// counted from what the function and its gradient must do, not from these
// loops (chip_smoke.py, scan_fwd_work / scan_bwd_work). Forward: 0.675 GB
// of inputs and outputs (0.202 ms at 3.35 TB/s; the states this design
// writes and reads back not counted) against 12.9 GFLOP of products (0.026
// ms at the 495 TFLOP/s TF32 rate) and 3.6 GFLOP of elementwise work
// (0.053 ms at 67 TFLOP/s): bytes bound it; on fp32 cores alone the 16.5
// GFLOP would take 0.246 ms. Backward: 33.2 GFLOP of fp32 operations (0.50
// ms at 67 TFLOP/s) against 1.21 GB (0.36 ms; the states and dstates not
// counted). The gradient pass is not at it: it forms each pair decay three
// times (for A, dr and dk), 15 operations per (t, i, k) where the gradient
// needs 10, reads two or three shared-memory operands for each of them, and
// runs every product on fp32 cores, where the forward's output pass uses
// tensor cores and 16-token sub-chunks.
//
// The sums run in another order than the plain PyTorch versions in
// rwkv6_chunk.py, so the two agree to a tolerance, not bit for bit. The
// cumsums run in the plain version's order. Every exponential is __expf of
// a difference <= 0 (see the state pass).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 16;          // sub-chunk: tokens per diagonal block

// Cumsums of a chunk's logw down each column, one thread per column, in
// the plain version's order: cw (in place over logw, row stride ldw) a
// running sum, cx = cw - logw (row stride ldx). Each of cx, tv (T =
// cw[C-1]) and bsub (b_p = cx[16 p], row stride K) is written unless it is
// nullptr. Rows are read 16 at a time (C is a multiple of 16), so only the
// adds wait on each other.
__device__ __forceinline__ void cumsums(int C, int K, int ldw, int ldx,
                                        float* cw, float* cx, float* tv,
                                        float* bsub) {
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    float acc = 0.f;
    for (int t0 = 0; t0 < C; t0 += kSub) {
      float x[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) x[j] = cw[(t0 + j) * ldw + kk];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        acc += x[j];
        cw[(t0 + j) * ldw + kk] = acc;
        if (cx != nullptr) cx[(t0 + j) * ldx + kk] = acc - x[j];
        if (bsub != nullptr && j == 0)
          bsub[(t0 / kSub) * K + kk] = acc - x[j];
      }
    }
    if (tv != nullptr) tv[kk] = acc;
  }
}

// ---------------------------------------------------------------------------
// Shared pieces: cp.async, tensor-core fragments
// ---------------------------------------------------------------------------

constexpr int kOutThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols floats (cols a multiple of 4; every row 16-byte aligned on
// both sides) from global rows of stride gld to shared rows of stride ld
__device__ __forceinline__ void load_tile_async(float* dst, int ld,
                                                const float* __restrict__ src,
                                                int64_t gld, int rows,
                                                int cols) {
  const int q = cols / 4;
  for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
    const int a = idx / q, b = (idx - a * q) * 4;
    cp_async16(dst + a * ld + b, src + a * gld + b);
  }
}

// Tensor-core products in 3xTF32: each fp32 operand x is split into a TF32
// x_hi and a TF32 x_lo ~= x - x_hi, and a b ~= a_lo b_hi + a_hi b_lo +
// a_hi b_hi (the small terms first), summed in fp32: about fp32's accuracy,
// where plain TF32 keeps ~3 decimal digits.
// x rounded to TF32, to nearest with ties away from zero (cvt.rna's
// rounding), in two integer operations: cvt.rna.tf32.f32 issues at a
// fraction of the integer units' rate
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const float* x, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    hi[j] = to_tf32(x[j]);
    lo[j] = to_tf32(x[j] - __uint_as_float(hi[j]));
  }
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8 fragment) += a (16 x 8) b (8 x 8); b given split (a B
// fragment serves several A fragments)
__device__ __forceinline__ void mma_3xtf32(float* d, const float* a,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  uint32_t ah[4], al[4];
  split_tf32<4>(a, ah, al);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Fragments of mma.m16n8k8 (lane = 4 g + q). A (16 x 8): a0 (g, q), a1
// (g+8, q), a2 (g, q+4), a3 (g+8, q+4); B (8 x 8): b0 (q, g), b1 (q+4, g);
// C (16 x 8): c0, c1 (g, 2q, 2q+1), c2, c3 (g+8, 2q, 2q+1). Each loader
// names where element (row, col) of its operand lies; the row strides are
// chosen so that the 32 lanes hit 32 banks: ld = 4 mod 8 where g walks
// rows, ld = 8 mod 16 where q walks rows.
// A from a row-major tile: (m, kk) at p[m * ld + kk]
__device__ __forceinline__ void frag_a(float* a, const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  a[0] = p[g * ld + q];
  a[1] = p[(g + 8) * ld + q];
  a[2] = p[g * ld + q + 4];
  a[3] = p[(g + 8) * ld + q + 4];
}

// A from a transposed tile: (m, kk) at p[kk * ld + m]
__device__ __forceinline__ void frag_a_t(float* a, const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  a[0] = p[q * ld + g];
  a[1] = p[q * ld + g + 8];
  a[2] = p[(q + 4) * ld + g];
  a[3] = p[(q + 4) * ld + g + 8];
}

// B from a row-major tile: (kk, n) at p[kk * ld + n]
__device__ __forceinline__ void frag_b(float* b, const float* p, int64_t ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  b[0] = p[q * ld + g];
  b[1] = p[(q + 4) * ld + g];
}

// B from a transposed tile: (kk, n) at p[n * ld + kk]
__device__ __forceinline__ void frag_b_t(float* b, const float* p, int ld) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  b[0] = p[g * ld + q];
  b[1] = p[g * ld + q + 4];
}

// C fragment rows g and g + 8 of a tile, columns 2q, 2q + 1, at p (row
// stride ld)
__device__ __forceinline__ void store_frag(float* p, int64_t ld,
                                           const float* d) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  *reinterpret_cast<float2*>(p + g * ld + 2 * q) = make_float2(d[0], d[1]);
  *reinterpret_cast<float2*>(p + (g + 8) * ld + 2 * q) =
      make_float2(d[2], d[3]);
}

// ---------------------------------------------------------------------------
// The state pass (forward pass 1, backward pass 1), the only sequential part
// ---------------------------------------------------------------------------
//
// One CTA per bh, 2 x V / 8 warps: warp w carries state columns
// 8 (w mod V/8).. +7 of the m-tiles (16-row blocks) of its half, mt = w div
// (V/8) + 2 j, in its accumulator fragments across all chunks. Per chunk:
// write the state before the chunk's update to `states`, then S <-
// diag(e^T) S + X^T B on tensor cores, while the next chunk's operands are
// in flight (cp.async, two stages). Forward: chunks in order from s0, X =
// k e^{T-cw}, B = v, writing the chunk-start states and s_out. Reverse (the
// backward's dS): chunks in descending order from ds_final, X = r e^{cx},
// B = dy, writing the gradient of the state after each chunk (`dstates`)
// and ds0. One CTA per bh reads each input once; the chain of chunks is the
// pass's latency.

size_t state_smem_floats(int C, int K, int V) {
  // two stages of k, logw (C x (K + 8)) and v (C x (V + 8)) | T
  return 2 * ((size_t)2 * C * (K + 8) + (size_t)C * (V + 8)) + K;
}

constexpr int kStateMaxThreads = 2 * 64 / 8 * 32;

template <bool kReverse>
__global__ void __launch_bounds__(kStateMaxThreads)
rwkv6_state_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                   const float* __restrict__ w, const float* __restrict__ init,
                   float* __restrict__ states, float* __restrict__ last,
                   int64_t S, int C, int K, int V) {
  extern __shared__ float smem[];
  const int ldk = K + 8, ldv = V + 8;   // 8 mod 16: q walks their rows
  const int64_t b = blockIdx.x;
  const int n_chunks = (int)(S / C);
  const int stage = 2 * C * ldk + C * ldv;
  float* tv = smem + 2 * stage;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int col = (warp % (V / 8)) * 8;      // this warp's columns
  const int mt0 = warp / (V / 8);            // its m-tiles: mt0, mt0 + 2
  const int n_mt = K / 16;
  const int g = (threadIdx.x & 31) >> 2;

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (mt0 + 2 * j < n_mt) {
      const int q = threadIdx.x & 3;
      const float* src = init + (b * K + (mt0 + 2 * j) * 16 + g) * V + col +
                         2 * q;
      const float2 lo = *reinterpret_cast<const float2*>(src);
      const float2 hi = *reinterpret_cast<const float2*>(src + 8 * V);
      acc[j][0] = lo.x, acc[j][1] = lo.y, acc[j][2] = hi.x, acc[j][3] = hi.y;
    }

  // the j-th chunk of the walk
  auto chunk_at = [&](int j) { return kReverse ? n_chunks - 1 - j : j; };
  auto issue = [&](int j, int buf) {
    float* ks = smem + buf * stage;
    const int64_t row0 = b * S + (int64_t)chunk_at(j) * C;
    load_tile_async(ks, ldk, a + row0 * K, K, C, K);
    load_tile_async(ks + C * ldk, ldk, w + row0 * K, K, C, K);
    load_tile_async(ks + 2 * C * ldk, ldv, bm + row0 * V, V, C, V);
  };
  issue(0, 0);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) issue(c + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* ks = smem + buf * stage;     // A: k (r), then k e^{T-cw} (r e^{cx})
    float* cw = ks + C * ldk;           // logw, then cw (cx)
    const float* vs = cw + C * ldk;     // B: v (dy), C x V
    float* dst = states + (b * n_chunks + chunk_at(c)) * (int64_t)K * V + col;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (mt0 + 2 * j < n_mt)
        store_frag(dst + (mt0 + 2 * j) * 16 * V, V, acc[j]);
    // in reverse, cx is written over cw (each row's cw is read before its
    // cx is stored)
    cumsums(C, K, ldk, ldk, cw, kReverse ? cw : nullptr, tv, nullptr);
    __syncthreads();
    // the exponentials are __expf (the MUFU exponential of x log2(e)) of
    // differences <= 0, up to the cumsums' rounding: its relative error,
    // about (|x| + 4) 2^-24, stays below 2e-6 wherever e^x is above 1e-9;
    // expf's range reduction costs four times the instructions
    for (int i = warp; i < C; i += n_warps)
      for (int kk = threadIdx.x & 31; kk < K; kk += 32)
        ks[i * ldk + kk] *= __expf(kReverse ? cw[i * ldk + kk]
                                            : tv[kk] - cw[i * ldk + kk]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (mt0 + 2 * j < n_mt) {
        const int row = (mt0 + 2 * j) * 16 + g;
        const float e0 = __expf(tv[row]), e1 = __expf(tv[row + 8]);
        acc[j][0] *= e0, acc[j][1] *= e0, acc[j][2] *= e1, acc[j][3] *= e1;
      }
    for (int k8 = 0; k8 < C; k8 += 8) {
      float bb[2];
      uint32_t bh[2], bl[2];
      frag_b(bb, vs + k8 * ldv + col, ldv);
      split_tf32<2>(bb, bh, bl);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (mt0 + 2 * j < n_mt) {
          float a[4];
          frag_a_t(a, ks + k8 * ldk + (mt0 + 2 * j) * 16, ldk);
          mma_3xtf32(acc[j], a, bh, bl);
        }
    }
    __syncthreads();
  }
  float* dst = last + b * K * V + col;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (mt0 + 2 * j < n_mt) store_frag(dst + (mt0 + 2 * j) * 16 * V, V, acc[j]);
}

// ---------------------------------------------------------------------------
// Forward, pass 2: the output pass, every chunk independent
// ---------------------------------------------------------------------------
//
// One CTA per (bh, chunk), 8 warps, from the chunk's r, k, v, logw and its
// start state S (written by the state pass):
//   y = (r e^{cx}) S + A v,  A[t, i] for i < t as in the header, A[t, t]
//   the bonus r[t].u.k[t].
// With sub-chunks of 16 tokens and b_p the exclusive cumsum at the start
// of t's sub-chunk p, a block of A below the diagonal blocks is the product
// (r e^{cx - b_p}) (k e^{b_p - cw})^T: both exponents are <= 0 (logw <= 0),
// so neither factor overflows, and where one underflows the true product is
// smaller still. Only the diagonal 16 x 16 blocks take e^{cx[t]-cw[i]}
// pairwise (4 x 120 pairs x K exponentials at C = 64, against C(C-1)/2 x K
// for the whole chunk). The products (A's lower blocks, (r e^{cx}) S, A v)
// run on tensor cores in 3xTF32; S and v go from global memory straight
// into B fragments, so shared memory holds the (C, K) tiles only.
//
// Shared memory (floats), ld = K + 4 (4 mod 8: g walks the rows):
//   rs  C x ld   r, then r e^{cx - b}
//   ks  C x lda  k, then A (lda = max(C, K) + 4)
//   cw  C x ld   logw, then its cumsum
//   cx  C x ld   cx, then r e^{cx}
//   kt  R x ld   k e^{b_p - cw} for each p >= 1 and i < 16 p (R = 16 np
//                (np - 1) / 2 rows, np = C / 16 sub-chunks)
//   bs  np x K   b_p;  us K   u

size_t out_smem_floats(int C, int K) {
  const size_t ld = K + 4, lda = (C > K ? C : K) + 4, np = C / kSub;
  return 3 * (size_t)C * ld + (size_t)C * lda + 8 * np * (np - 1) * ld +
         np * K + K;
}

__global__ void __launch_bounds__(kOutThreads, 2)
rwkv6_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u,
                 const float* __restrict__ states, float* __restrict__ y,
                 int64_t S, int C, int K, int V) {
  extern __shared__ float smem[];
  const int ld = K + 4, lda = (C > K ? C : K) + 4, np = C / kSub;
  const int n_chunks = (int)(S / C);
  const int64_t b = blockIdx.x / n_chunks;
  const int c = (int)(blockIdx.x - b * n_chunks);
  float* rs = smem;
  float* ks = rs + C * ld;
  float* cw = ks + C * lda;
  float* cx = cw + C * ld;
  float* kt = cx + C * ld;
  float* bs = kt + 8 * np * (np - 1) * ld;
  float* us = bs + np * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5;
  const int64_t row0 = b * S + (int64_t)c * C;

  load_tile_async(rs, ld, r + row0 * K, K, C, K);
  load_tile_async(ks, ld, k + row0 * K, K, C, K);
  load_tile_async(cw, ld, w + row0 * K, K, C, K);
  cp_async_commit();
  // this warp's n-tile of y (columns 8 warp..8 warp+7): the B fragments of
  // S and of v, straight from global memory while the tiles load
  const bool has_cols = warp * 8 < V;
  float sf[8][2], vf[8][2];
  if (has_cols) {
    const float* st = states + (b * n_chunks + c) * (int64_t)K * V + warp * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j * 8 < K) frag_b(sf[j], st + j * 8 * V, V);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j * 8 < C) frag_b(vf[j], v + (row0 + j * 8) * V + warp * 8, V);
  }
  for (int kk = tid; kk < K; kk += nt) us[kk] = u[b * K + kk];
  cp_async_wait<0>();
  __syncthreads();

  cumsums(C, K, ld, ld, cw, cx, nullptr, bs);
  __syncthreads();

  // k e^{b_p - cw} for the blocks below the diagonal, on warps 1..7
  // (warp 0 takes the diagonal entries past 2 per thread)
  if (warp > 0)
    for (int p = 1; p < np; ++p) {
      float* dst = kt + 8 * p * (p - 1) * ld;
      for (int i = warp - 1; i < kSub * p; i += nt / 32 - 1)
        for (int kk = tid & 31; kk < K; kk += 32)
          dst[i * ld + kk] =
              ks[i * ld + kk] * __expf(bs[p * K + kk] - cw[i * ld + kk]);
    }
  // the diagonal blocks, pairwise: entry e = (block p, t >= i within it);
  // two partial sums per entry (two chains)
  constexpr int kTri = kSub * (kSub + 1) / 2;
  float diag[3];
  int diag_at[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int e = tid + j * nt;
    diag_at[j] = -1;
    if (e < np * kTri) {
      const int p = e / kTri;
      const int idx = e - p * kTri;
      int tl = 0;
      while ((tl + 1) * (tl + 2) / 2 <= idx) ++tl;
      const int il = idx - tl * (tl + 1) / 2;
      const int t = p * kSub + tl, i = p * kSub + il;
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * ld);
      const float4* k4 = reinterpret_cast<const float4*>(ks + i * ld);
      float a0 = 0.f, a1 = 0.f;
      if (i < t) {
        const float4* x4 = reinterpret_cast<const float4*>(cx + t * ld);
        const float4* w4 = reinterpret_cast<const float4*>(cw + i * ld);
        for (int k4i = 0; k4i < K / 4; ++k4i) {
          const float4 rr = r4[k4i], kv = k4[k4i], xx = x4[k4i],
                       ww = w4[k4i];
          a0 = fmaf(rr.x * kv.x, __expf(xx.x - ww.x), a0);
          a1 = fmaf(rr.y * kv.y, __expf(xx.y - ww.y), a1);
          a0 = fmaf(rr.z * kv.z, __expf(xx.z - ww.z), a0);
          a1 = fmaf(rr.w * kv.w, __expf(xx.w - ww.w), a1);
        }
      } else {
        const float4* u4 = reinterpret_cast<const float4*>(us);
        for (int k4i = 0; k4i < K / 4; ++k4i) {
          const float4 rr = r4[k4i], kv = k4[k4i], uu = u4[k4i];
          a0 = fmaf(rr.x * uu.x, kv.x, a0);
          a1 = fmaf(rr.y * uu.y, kv.y, a1);
          a0 = fmaf(rr.z * uu.z, kv.z, a0);
          a1 = fmaf(rr.w * uu.w, kv.w, a1);
        }
      }
      diag[j] = a0 + a1;
      diag_at[j] = t * lda + i;
    }
  }
  __syncthreads();

  // k is dead: A takes its place. The diagonal blocks, with zeros above
  // their diagonal; r e^{cx} over cx and r e^{cx - b} over r, in place
  float* att = ks;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (diag_at[j] >= 0) att[diag_at[j]] = diag[j];
  for (int e = tid; e < np * kSub * kSub; e += nt) {
    const int p = e / (kSub * kSub), tl = (e / kSub) % kSub, il = e % kSub;
    if (il > tl) att[(p * kSub + tl) * lda + p * kSub + il] = 0.f;
  }
  for (int t = warp; t < C; t += nt / 32)
    for (int kk = tid & 31; kk < K; kk += 32) {
      const float x = cx[t * ld + kk], rv = rs[t * ld + kk];
      cx[t * ld + kk] = rv * __expf(x);
      rs[t * ld + kk] = rv * __expf(x - bs[(t / kSub) * K + kk]);
    }
  __syncthreads();

  // A below the diagonal blocks: tile j = (p, n-tile n), p >= 1, n < 2 p;
  // even and odd k-steps in two accumulators (two chains)
  for (int j = warp; j < np * (np - 1); j += nt / 32) {
    int p = 1;
    while ((p + 1) * p <= j) ++p;           // tiles of p: [p (p-1), p (p+1))
    const int n = j - p * (p - 1);
    float d[2][4] = {};
    const float* kp = kt + (8 * p * (p - 1) + n * 8) * ld;
    for (int k16 = 0; k16 < K; k16 += 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a[4], bb[2];
        uint32_t bh[2], bl[2];
        frag_a(a, rs + p * kSub * ld + k16 + 8 * h, ld);
        frag_b_t(bb, kp + k16 + 8 * h, ld);
        split_tf32<2>(bb, bh, bl);
        mma_3xtf32(d[h], a, bh, bl);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) d[0][x] += d[1][x];
    store_frag(att + p * kSub * lda + n * 8, lda, d[0]);
  }
  __syncthreads();

  // y = (r e^{cx}) S + A v: this warp's columns, the m-tiles of rows side
  // by side (independent chains); A's blocks above the diagonal are never
  // read
  if (has_cols) {
    float d[4][4] = {};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j * 8 < K) {
        uint32_t bh[2], bl[2];
        split_tf32<2>(sf[j], bh, bl);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (mt < np) {
            float a[4];
            frag_a(a, cx + mt * kSub * ld + j * 8, ld);
            mma_3xtf32(d[mt], a, bh, bl);
          }
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j * 8 < C) {
        uint32_t bh[2], bl[2];
        split_tf32<2>(vf[j], bh, bl);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (mt < np && j * 8 < (mt + 1) * kSub) {
            float a[4];
            frag_a(a, att + mt * kSub * lda + j * 8, lda);
            mma_3xtf32(d[mt], a, bh, bl);
          }
      }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      if (mt < np) store_frag(y + (row0 + mt * kSub) * V + warp * 8, V, d[mt]);
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 2: the gradient pass, every chunk independent
// ---------------------------------------------------------------------------
//
// One CTA per (bh, chunk), 256 threads, from the chunk's r, k, v, logw, dy
// and u, its start state S (`states`) and the gradient dS' of the state
// after it (`dstates`, the reverse state pass's). With dA[t, i] = dy[t].v[i]
// and E = e^{cx[t]-cw[i]} (i < t), for column k:
//   dv  = A^T dy + bonus dy + (k e^{T-cw}) dS'
//   dr  = e^{cx} (S dy) + sum_i dA E k[i] + d(bonus) u k
//   dk  = sum_t dA E r[t] + d(bonus) u r + e^{T-cw} (v dS'^T)
//   dlogw[t] = dT + sum_{t' > t} (dcx + dcw)[t'] + dcw[t], with dcx, dcw
//   the gradients in cx and cw and dT = e^T sum_v S dS' + sum_i k e^{T-cw}
//   (v dS'^T)
// and du's partial sum_t d(bonus) r k into `du_part`. Every pair decay is
// formed pairwise where it is summed (for A, for dr and for dk): scalar
// fp32, __expf as in the forward. Phases, each with all 8 warps busy:
//   1. cumsums down the columns (threads < K) beside the bonus and
//      d(bonus), one thread per t each;
//   2. A and dA, one thread per pair i < t;
//   3. per column k, G = 256 / K threads, each a run of consecutive rows:
//      S dy and v dS'^T (S and dS' rows straight from global memory), then
//      the rows in reverse with the pairwise sums, dr and dk stored, the
//      dlogw terms of its own rows kept in registers; after a sync, the
//      column's partials meet in shared memory, and dlogw and du's partial
//      are stored;
//   4. dv, with k e^{T-cw} written over cx, dS' from global memory.
// Shared memory (floats): rs, cx C x K; ks, cw C x (K + 1) (odd: phase 2's
// lanes walk their rows); vs C x V (then the partials); dys C x V; att
// C x (C + 1): A below the diagonal, dA transposed above it, the bonus on
// it, d(bonus) in column C. 115,456 B at C = K = V = 64: two CTAs per SM.

constexpr int kGradThreads = 256;
// most rows a thread holds in phases 3 and 4: ceil(C / (256 / K)) at C = K
// = 64, and no more at any admitted shape
constexpr int kGradRows = 16;

size_t grad_smem_floats(int C, int K, int V) {
  const size_t cv = (size_t)C * V;
  return 2 * (size_t)C * K + 2 * (size_t)C * (K + 1) +
         (cv > 3 * (size_t)kGradThreads ? cv : 3 * (size_t)kGradThreads) + cv +
         (size_t)C * (C + 1);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// j + o wrapped into [0, n) (o < n): lanes that start a walk at different
// o read different banks of rows whose stride is a multiple of 32
__device__ __forceinline__ int rot(int j, int o, int n) {
  const int x = j + o;
  return x < n ? x : x - n;
}

__global__ void __launch_bounds__(kGradThreads, 2)
rwkv6_grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u,
                  const float* __restrict__ states,
                  const float* __restrict__ dstates,
                  const float* __restrict__ dy, float* __restrict__ dr,
                  float* __restrict__ dk, float* __restrict__ dv,
                  float* __restrict__ dw, float* __restrict__ du_part,
                  int64_t S, int C, int K, int V) {
  extern __shared__ float smem[];
  const int ldk = K + 1, ldc = C + 1;
  const int n_chunks = (int)(S / C);
  const int64_t b = blockIdx.x / n_chunks;
  const int c = (int)(blockIdx.x - b * n_chunks);
  const int cv = C * V;
  float* rs = smem;                     // C x K
  float* cx = rs + C * K;               // C x K     cx, then k e^{T-cw}
  float* ks = cx + C * K;               // C x ldk
  float* cw = ks + C * ldk;             // C x ldk   logw, then cw
  float* vs = cw + C * ldk;             // C x V     v, then the partials
  float* dys = vs + (cv > 3 * kGradThreads ? cv : 3 * kGradThreads);   // C x V
  float* att = dys + cv;                // C x ldc
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t row0 = b * S + (int64_t)c * C;
  const int64_t sidx = (b * n_chunks + c) * (int64_t)K * V;
  const float* ub = u + b * K;

  load_tile_async(rs, K, r + row0 * K, K, C, K);
  load_tile_async(vs, V, v + row0 * V, V, C, V);
  load_tile_async(dys, V, dy + row0 * V, V, C, V);
  for (int idx = tid; idx < C * K; idx += nt) {
    const int i = idx / K, kk = idx - i * K;
    cp_async4(ks + i * ldk + kk, k + row0 * K + idx);
    cp_async4(cw + i * ldk + kk, w + row0 * K + idx);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. cumsums (threads < K); the bonus r[t].u.k[t] and d(bonus) =
  // dy[t].v[t] (threads K.., one t each, walks rotated by t)
  cumsums(C, K, ldk, K, cw, cx, nullptr, nullptr);
  if (tid >= K && tid < K + 2 * C) {
    const int t = (tid - K) % C;
    float acc = 0.f;
    if (tid < K + C) {
      for (int j = 0; j < K; ++j) {
        const int kk = rot(j, t % K, K);
        acc = fmaf(rs[t * K + kk] * __ldg(ub + kk), ks[t * ldk + kk], acc);
      }
      att[t * ldc + t] = acc;
    } else {
      for (int j = 0; j < V; ++j) {
        const int vv = rot(j, t % V, V);
        acc = fmaf(dys[t * V + vv], vs[t * V + vv], acc);
      }
      att[t * ldc + C] = acc;
    }
  }
  __syncthreads();

  // 2. A[t, i] and dA[t, i] for i < t, one thread per pair, pairs packed
  // row by row (e = t (t - 1) / 2 + i): a warp's lanes share t, so r[t] and
  // cx[t] are broadcast and k[i], cw[i] rows of odd stride; two chains each
  for (int e = tid; e < C * (C - 1) / 2; e += nt) {
    int t = (int)((1.f + sqrtf(1.f + 8.f * (float)e)) * 0.5f);
    while (t * (t - 1) / 2 > e) --t;
    while ((t + 1) * t / 2 <= e) ++t;
    const int i = e - t * (t - 1) / 2;
    const float* rt = rs + t * K;
    const float* xt = cx + t * K;
    const float* ki = ks + i * ldk;
    const float* wi = cw + i * ldk;
    float a0 = 0.f, a1 = 0.f;
    for (int kk = 0; kk < K; kk += 2) {
      a0 = fmaf(rt[kk] * ki[kk], __expf(xt[kk] - wi[kk]), a0);
      a1 = fmaf(rt[kk + 1] * ki[kk + 1], __expf(xt[kk + 1] - wi[kk + 1]),
                a1);
    }
    // v rows have stride V: rotated walks, by i
    const float* yt = dys + t * V;
    const float* vi = vs + i * V;
    const int o = i % V;
    float d0 = 0.f, d1 = 0.f;
    for (int j = 0; j < V; j += 2) {
      const int v0 = rot(j, o, V), v1 = rot(j + 1, o, V);
      d0 = fmaf(yt[v0], vi[v0], d0);
      d1 = fmaf(yt[v1], vi[v1], d1);
    }
    att[t * ldc + i] = a0 + a1;
    att[i * ldc + t] = d0 + d1;
  }
  __syncthreads();

  // 3. column col, rows t0 .. t0 + nrows - 1
  const int G = nt / K;
  const int col = tid % K, grp = tid / K;
  const int R = (C + G - 1) / G;
  const int t0 = grp * R;
  const int nrows = grp < G ? max(0, min(R, C - t0)) : 0;
  const float T = cw[(C - 1) * ldk + col];
  float h[kGradRows];       // dcw[t] + sum of (dcx + dcw) over own rows > t
  float gsum = 0.f, sk = 0.f, dup = 0.f, s_ds = 0.f;
  if (nrows > 0) {
    float sdy[kGradRows], vds[kGradRows];
#pragma unroll
    for (int j = 0; j < kGradRows; ++j) sdy[j] = vds[j] = 0.f;
    const float* srow = states + sidx + (int64_t)col * V;
    const float* drow = dstates + sidx + (int64_t)col * V;
    for (int v0 = 0; v0 < V; v0 += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(srow + v0);
      const float4 d4 = *reinterpret_cast<const float4*>(drow + v0);
      s_ds = fmaf(s4.x, d4.x, s_ds);
      s_ds = fmaf(s4.y, d4.y, s_ds);
      s_ds = fmaf(s4.z, d4.z, s_ds);
      s_ds = fmaf(s4.w, d4.w, s_ds);
#pragma unroll
      for (int j = 0; j < kGradRows; ++j)
        if (j < nrows) {
          const float4 y4 =
              *reinterpret_cast<const float4*>(dys + (t0 + j) * V + v0);
          const float4 x4 =
              *reinterpret_cast<const float4*>(vs + (t0 + j) * V + v0);
          sdy[j] = fmaf(s4.x, y4.x, sdy[j]);
          sdy[j] = fmaf(s4.y, y4.y, sdy[j]);
          sdy[j] = fmaf(s4.z, y4.z, sdy[j]);
          sdy[j] = fmaf(s4.w, y4.w, sdy[j]);
          vds[j] = fmaf(d4.x, x4.x, vds[j]);
          vds[j] = fmaf(d4.y, x4.y, vds[j]);
          vds[j] = fmaf(d4.z, x4.z, vds[j]);
          vds[j] = fmaf(d4.w, x4.w, vds[j]);
        }
    }
    const float uk = __ldg(ub + col);
#pragma unroll
    for (int j = kGradRows - 1; j >= 0; --j)
      if (j < nrows) {
        const int t = t0 + j;
        const float cxt = cx[t * K + col], cwt = cw[t * ldk + col];
        const float kt = ks[t * ldk + col], rt = rs[t * K + col];
        const float dbt = att[t * ldc + C];
        const float dr_inter = __expf(cxt) * sdy[j];
        float p_r = 0.f;
        for (int i = 0; i < t; ++i)
          p_r = fmaf(att[i * ldc + t] * ks[i * ldk + col],
                     __expf(cxt - cw[i * ldk + col]), p_r);
        float p_k = 0.f;
        for (int i = t + 1; i < C; ++i)
          p_k = fmaf(att[t * ldc + i] * rs[i * K + col],
                     __expf(cx[i * K + col] - cwt), p_k);
        const float dk_state = __expf(T - cwt) * vds[j];
        dr[(row0 + t) * K + col] = dr_inter + p_r + dbt * uk * kt;
        dk[(row0 + t) * K + col] = p_k + dbt * uk * rt + dk_state;
        const float dcw = -kt * (p_k + dk_state);
        h[j] = gsum + dcw;
        gsum += rt * (dr_inter + p_r) + dcw;
        sk = fmaf(kt, dk_state, sk);
        dup = fmaf(dbt * rt, kt, dup);
      }
  }
  __syncthreads();

  // the column partials (G x K each) over v; k e^{T-cw} over cx
  float* gpart = vs;
  float* skpart = gpart + G * K;
  float* dupart = skpart + G * K;
  if (grp < G) {
    gpart[grp * K + col] = gsum;
    skpart[grp * K + col] = sk;
    dupart[grp * K + col] = dup;
  }
  for (int j = 0; j < nrows; ++j) {
    const int t = t0 + j;
    cx[t * K + col] = ks[t * ldk + col] * __expf(T - cw[t * ldk + col]);
  }
  __syncthreads();
  if (nrows > 0) {
    float later = 0.f, sk_all = 0.f;
    for (int g2 = G - 1; g2 > grp; --g2) later += gpart[g2 * K + col];
    for (int g2 = 0; g2 < G; ++g2) sk_all += skpart[g2 * K + col];
    // dT plus the sums of the later rows' groups
    const float base = (__expf(T) * s_ds + sk_all) + later;
#pragma unroll
    for (int j = 0; j < kGradRows; ++j)
      if (j < nrows) dw[(row0 + t0 + j) * K + col] = base + h[j];
    if (grp == 0) {
      float d = 0.f;
      for (int g2 = 0; g2 < G; ++g2) d += dupart[g2 * K + col];
      du_part[(b * n_chunks + c) * K + col] = d;
    }
  }

  // 4. dv: column vv, rows gv, gv + GV, ... (a warp shares its rows)
  const int GV = nt / V;
  const int vv = tid % V, gv = tid / V;
  if (gv < GV) {
    float acc[kGradRows];
#pragma unroll
    for (int n = 0; n < kGradRows; ++n) acc[n] = 0.f;
    const float* dsc = dstates + sidx + vv;
    for (int k0 = 0; k0 < K; k0 += 4) {
      const float e0 = dsc[(int64_t)k0 * V], e1 = dsc[(int64_t)(k0 + 1) * V],
                  e2 = dsc[(int64_t)(k0 + 2) * V],
                  e3 = dsc[(int64_t)(k0 + 3) * V];
#pragma unroll
      for (int n = 0; n < kGradRows; ++n) {
        const int i = gv + n * GV;
        if (i < C) {
          const float4 kd = *reinterpret_cast<const float4*>(cx + i * K + k0);
          acc[n] = fmaf(kd.x, e0, acc[n]);
          acc[n] = fmaf(kd.y, e1, acc[n]);
          acc[n] = fmaf(kd.z, e2, acc[n]);
          acc[n] = fmaf(kd.w, e3, acc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kGradRows; ++n) {
      const int i = gv + n * GV;
      if (i < C) {
        float a = fmaf(att[i * ldc + i], dys[i * V + vv], acc[n]);
        for (int t = i + 1; t < C; ++t)
          a = fmaf(att[t * ldc + i], dys[t * V + vv], a);
        dv[(row0 + i) * V + vv] = a;
      }
    }
  }
}

// du: the per-chunk partials summed in chunk order, one thread per (bh, k)
__global__ void rwkv6_du_kernel(const float* __restrict__ part,
                                float* __restrict__ du, int64_t bh,
                                int n_chunks, int K) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= bh * K) return;
  const int64_t b = idx / K;
  const float* p = part + b * n_chunks * K + (idx - b * K);
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += p[(int64_t)c * K];
  du[idx] = acc;
}

int launch_checked(const void* fn, size_t smem_bytes) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem_bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
}

}  // namespace

// Plain C interface (bound with ctypes). r, k, logw: (bh, s, K); v: (bh, s,
// V); u: (bh, K); s0, s_out: (bh, K, V); y: (bh, s, V); states: (bh,
// s/chunk, K, V), written by the state pass and read by the output pass.
// s is a multiple of chunk; chunk, K, V multiples of 16 up to 64; every
// pointer 16-byte aligned. Launches both passes on `stream`; returns the
// first CUDA error (0 on success).
extern "C" int rwkv6_fwd_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, void* states,
                                int64_t bh, int64_t s, int chunk, int kdim,
                                int vdim, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem1 = state_smem_floats(chunk, kdim, vdim) * sizeof(float);
  int err = launch_checked((const void*)rwkv6_state_kernel<false>, smem1);
  if (err != 0) return err;
  rwkv6_state_kernel<false><<<(unsigned)bh, 2 * 32 * (vdim / 8), smem1, st>>>(
      (const float*)k, (const float*)v, (const float*)w, (const float*)s0,
      (float*)states, (float*)s_out, s, chunk, kdim, vdim);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem2 = out_smem_floats(chunk, kdim) * sizeof(float);
  err = launch_checked((const void*)rwkv6_out_kernel, smem2);
  if (err != 0) return err;
  rwkv6_out_kernel<<<(unsigned)(bh * (s / chunk)), kOutThreads, smem2, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)states, (float*)y, s, chunk, kdim,
      vdim);
  return (int)cudaGetLastError();
}

// dy: (bh, s, V); ds_final, ds0: (bh, K, V); dr, dk, dlogw: (bh, s, K); dv:
// (bh, s, V); du: (bh, K); states as the forward wrote them. Scratch:
// dstates (bh, s/chunk, K, V), the gradient of the state after every
// chunk; du_part (bh, s/chunk, K), du's partial of every chunk. Launches
// the reverse state pass, the gradient pass and du's reduction on
// `stream`; returns the first CUDA error (0 on success).
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* states, const void* dy,
                                const void* ds_final, void* dr, void* dk,
                                void* dv, void* dw, void* du, void* ds0,
                                void* dstates, void* du_part, int64_t bh,
                                int64_t s, int chunk, int kdim, int vdim,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (int)(s / chunk);
  const size_t smem1 = state_smem_floats(chunk, kdim, vdim) * sizeof(float);
  int err = launch_checked((const void*)rwkv6_state_kernel<true>, smem1);
  if (err != 0) return err;
  rwkv6_state_kernel<true><<<(unsigned)bh, 2 * 32 * (vdim / 8), smem1, st>>>(
      (const float*)r, (const float*)dy, (const float*)w,
      (const float*)ds_final, (float*)dstates, (float*)ds0, s, chunk, kdim,
      vdim);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t smem2 = grad_smem_floats(chunk, kdim, vdim) * sizeof(float);
  err = launch_checked((const void*)rwkv6_grad_kernel, smem2);
  if (err != 0) return err;
  rwkv6_grad_kernel<<<(unsigned)(bh * n_chunks), kGradThreads, smem2, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)states, (const float*)dstates,
      (const float*)dy, (float*)dr, (float*)dk, (float*)dv, (float*)dw,
      (float*)du_part, s, chunk, kdim, vdim);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  rwkv6_du_kernel<<<(unsigned)((bh * kdim + 255) / 256), 256, 0, st>>>(
      (const float*)du_part, (float*)du, bh, n_chunks, kdim);
  return (int)cudaGetLastError();
}
