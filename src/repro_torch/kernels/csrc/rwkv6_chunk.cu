// RWKV-6 chunked time-mix scan for Hopper (sm_90a): forward and backward.
//
// rwkv6_fwd replaces repro/kernels/rwkv6_chunk.py::rwkv6_chunk_scan (the
// Pallas kernel _kernel, grid (BH, n_chunks) with the (K, V) state resident
// across chunks). rwkv6_bwd is its gradient, which the reference leaves to
// XLA's differentiation of the model's jnp scan. All fp32.
//
// Per head and chunk of C tokens (cw / cx the inclusive / exclusive cumsum
// of logw over the chunk, T = cw[C-1]):
//   y[t]   = (r[t] e^{cx[t]}) S + sum_{i<t} A[t,i] v[i] + (r[t].u.k[t]) v[t]
//   A[t,i] = sum_k r[t,k] k[i,k] e^{cx[t,k] - cw[i,k]}
//   S'     = diag(e^T) S + sum_i (k[i] e^{T - cw[i]})^T v[i]
//
// Design (a simple kernel that is right; tensor cores and sub-chunking are
// later work). One CTA per bh walks its chunks in order (the forward) or in
// reverse (the backward), so the chunk loop inside the CTA takes the place
// of the TPU grid's sequential chunk axis. The (K, V) state (forward) or its
// gradient (backward) stays in shared memory across all chunks; every tile
// of the current chunk is loaded into shared memory once. The TPU kernel
// materialises the (C, C, K) pairwise decay (1 MB at C = K = 64, more than
// the 227 KB a CTA may use); here each (t, i, k) term is formed where it is
// summed, with e^{cx[t,k] - cw[i,k]} taken of the difference (<= 0 for
// i < t). It is never split into e^{cx} * e^{-cw}: logw reaches -e^8 per
// token in the model, so e^{-cw} overflows within a chunk. For the same
// reason the backward does not rebuild S from S' by dividing by e^T: the
// forward writes the state at the start of every chunk when asked
// (`states`, BH x n_chunks x K x V) and the backward reads it.
//
// Tiles whose rows are read by neighbouring threads (row index varying
// across a warp) are padded to an odd row stride, so those reads fall in
// different shared-memory banks.
//
// Bound at the rwkv6-7b training shape (BH 128, S 4096, K = V = C = 64),
// counted from what the function and its gradient must do, not from these
// loops (chip_smoke.py, scan_fwd_work / scan_bwd_work): about 2.0 M fp32
// operations per chunk forward and 4.05 M backward (8,192 chunk steps: 16.5
// and 33.2 GFLOP, 0.25 and 0.50 ms at 67 TFLOP/s) against 0.68 GB and 1.21
// GB of inputs and outputs (0.20 and 0.36 ms at 3.35 TB/s; the saved states
// not counted): fp32 operations bound both, exponentials included, taken
// out of the tensor cores. The backward here forms each pair decay three
// times (for A, dr and dk), 15 operations per (t, i, k) where the gradient
// needs 10.
//
// The sums run in another order than the plain PyTorch versions in
// rwkv6_chunk.py (sequential fmaf chains here), so the two agree to a
// tolerance, not bit for bit. Exponentials are expf (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// cw (inclusive, row stride ldk) and cx (exclusive, row stride K) cumsums
// of the chunk's logw, held in cw on entry; tv[k] = T = cw[C-1][k]. One
// thread per column.
__device__ __forceinline__ void cumsums(int C, int K, int ldk, float* cw,
                                        float* cx, float* tv) {
  for (int kk = threadIdx.x; kk < K; kk += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < C; ++t) {
      const float w = cw[t * ldk + kk];
      acc += w;
      cw[t * ldk + kk] = acc;
      cx[t * K + kk] = acc - w;
    }
    tv[kk] = acc;
  }
}

__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int a = idx / cols, b = idx - a * cols;
    dst[a * ld + b] = src[idx];
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float* src, int ld,
                                           int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int a = idx / cols, b = idx - a * cols;
    dst[idx] = src[a * ld + b];
  }
}

size_t fwd_smem_floats(int C, int K, int V) {
  // st, rs, cx, vs, att | ks, cw (padded) | us, tv, bon
  return (size_t)K * V + 2 * (size_t)C * K + (size_t)C * V + (size_t)C * C +
         2 * (size_t)C * (K + 1) + 2 * K + C;
}

__global__ void __launch_bounds__(kThreads)
rwkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out,
                 float* __restrict__ states, int64_t S, int C, int K, int V) {
  extern __shared__ float smem[];
  const int ldk = K + 1;  // odd row stride: rows read across a warp
  const int64_t b = blockIdx.x;
  const int n_chunks = (int)(S / C);
  float* st = smem;                     // K x V      state
  float* rs = st + K * V;               // C x K      r, then r e^{cx}
  float* cx = rs + C * K;               // C x K
  float* vs = cx + C * K;               // C x V
  float* att = vs + C * V;              // C x C
  float* ks = att + C * C;              // C x ldk    k, then k e^{T - cw}
  float* cw = ks + C * ldk;             // C x ldk    logw, then its cumsum
  float* us = cw + C * ldk;             // K
  float* tv = us + K;                   // K
  float* bon = tv + K;                  // C

  const int tid = threadIdx.x, nt = blockDim.x;
  for (int idx = tid; idx < K * V; idx += nt) st[idx] = s0[b * K * V + idx];
  for (int kk = tid; kk < K; kk += nt) us[kk] = u[b * K + kk];
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int64_t row0 = b * S + (int64_t)c * C;  // first token of the chunk
    if (states != nullptr) {
      float* dst = states + (b * n_chunks + c) * (int64_t)K * V;
      for (int idx = tid; idx < K * V; idx += nt) dst[idx] = st[idx];
    }
    load_tile(rs, K, r + row0 * K, C, K);
    load_tile(ks, ldk, k + row0 * K, C, K);
    load_tile(vs, V, v + row0 * V, C, V);
    load_tile(cw, ldk, w + row0 * K, C, K);
    __syncthreads();
    cumsums(C, K, ldk, cw, cx, tv);
    __syncthreads();

    // intra-chunk pair weights A[t, i] (0 for i >= t) and the bonus
    for (int idx = tid; idx < C * C; idx += nt) {
      const int t = idx / C, i = idx - t * C;
      float a = 0.f;
      if (i < t) {
        for (int kk = 0; kk < K; ++kk) {
          const float e = expf(cx[t * K + kk] - cw[i * ldk + kk]);
          a = fmaf(rs[t * K + kk] * ks[i * ldk + kk], e, a);
        }
      }
      att[idx] = a;
    }
    for (int t = tid; t < C; t += nt) {
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk)
        acc = fmaf(rs[t * K + kk] * us[kk], ks[t * ldk + kk], acc);
      bon[t] = acc;
    }
    __syncthreads();

    // r e^{cx} and k e^{T - cw}, in place
    for (int idx = tid; idx < C * K; idx += nt) {
      const int t = idx / K, kk = idx - t * K;
      rs[idx] *= expf(cx[idx]);
      ks[t * ldk + kk] *= expf(tv[kk] - cw[t * ldk + kk]);
    }
    __syncthreads();

    // y = inter + intra + bonus
    for (int idx = tid; idx < C * V; idx += nt) {
      const int t = idx / V, vv = idx - t * V;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk)
        acc = fmaf(rs[t * K + kk], st[kk * V + vv], acc);
      for (int i = 0; i < t; ++i)
        acc = fmaf(att[t * C + i], vs[i * V + vv], acc);
      acc = fmaf(bon[t], vs[t * V + vv], acc);
      y[(row0 + t) * V + vv] = acc;
    }
    __syncthreads();

    // state carry
    for (int idx = tid; idx < K * V; idx += nt) {
      const int kk = idx / V, vv = idx - kk * V;
      float acc = st[idx] * expf(tv[kk]);
      for (int i = 0; i < C; ++i)
        acc = fmaf(ks[i * ldk + kk], vs[i * V + vv], acc);
      st[idx] = acc;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < K * V; idx += nt) s_out[b * K * V + idx] = st[idx];
}

size_t bwd_smem_floats(int C, int K, int V) {
  const size_t ck = (size_t)C * K, cc = (size_t)C * C;
  // ks, cw | vs | st, ds (padded) | rs, cx, kd, dcx, dcw | dys | A | dA |
  // tv, us, du | bon, db
  return 2 * (size_t)C * (K + 1) + (size_t)C * (V + 1) +
         2 * (size_t)K * (V + 1) + 5 * ck + (size_t)C * V +
         (cc > ck ? cc : ck) + cc + 3 * (size_t)K + 2 * (size_t)C;
}

__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u,
                 const float* __restrict__ states,
                 const float* __restrict__ dy,
                 const float* __restrict__ ds_final, float* __restrict__ dr,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dw, float* __restrict__ du,
                 float* __restrict__ ds0, int64_t S, int C, int K, int V) {
  extern __shared__ float smem[];
  const int ldk = K + 1, ldv = V + 1;  // odd row strides (see above)
  const int64_t b = blockIdx.x;
  const int n_chunks = (int)(S / C);
  const int ck = C * K, cc = C * C;
  float* ks = smem;                     // C x ldk
  float* cw = ks + C * ldk;             // C x ldk
  float* vs = cw + C * ldk;             // C x ldv
  float* st = vs + C * ldv;             // K x ldv    chunk-start state
  float* ds = st + K * ldv;             // K x ldv    dL/d(state after chunk)
  float* rs = ds + K * ldv;             // C x K
  float* cx = rs + ck;                  // C x K
  float* kd = cx + ck;                  // C x K      k e^{T-cw}, then r e^{cx}
  float* dcx = kd + ck;                 // C x K
  float* dcw = dcx + ck;                // C x K
  float* dys = dcw + ck;                // C x V
  float* att = dys + C * V;             // C x C      A, then k * dk_state
  float* datt = att + (cc > ck ? cc : ck);  // C x C
  float* tv = datt + cc;                // K
  float* us = tv + K;                   // K
  float* dus = us + K;                  // K          du, summed over chunks
  float* bon = dus + K;                 // C
  float* db = bon + C;                  // C

  const int tid = threadIdx.x, nt = blockDim.x;
  load_tile(ds, ldv, ds_final + b * K * V, K, V);
  for (int kk = tid; kk < K; kk += nt) {
    us[kk] = u[b * K + kk];
    dus[kk] = 0.f;
  }
  __syncthreads();

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int64_t row0 = b * S + (int64_t)c * C;
    load_tile(rs, K, r + row0 * K, C, K);
    load_tile(ks, ldk, k + row0 * K, C, K);
    load_tile(vs, ldv, v + row0 * V, C, V);
    load_tile(dys, V, dy + row0 * V, C, V);
    load_tile(cw, ldk, w + row0 * K, C, K);
    load_tile(st, ldv, states + (b * n_chunks + c) * (int64_t)K * V, K, V);
    __syncthreads();
    cumsums(C, K, ldk, cw, cx, tv);
    __syncthreads();

    // A, dA = dy v^T (both 0 for i >= t), bonus, d(bonus), k e^{T-cw}
    for (int idx = tid; idx < cc; idx += nt) {
      const int t = idx / C, i = idx - t * C;
      float a = 0.f, da = 0.f;
      if (i < t) {
        for (int kk = 0; kk < K; ++kk) {
          const float e = expf(cx[t * K + kk] - cw[i * ldk + kk]);
          a = fmaf(rs[t * K + kk] * ks[i * ldk + kk], e, a);
        }
        for (int vv = 0; vv < V; ++vv)
          da = fmaf(dys[t * V + vv], vs[i * ldv + vv], da);
      }
      att[idx] = a;
      datt[idx] = da;
    }
    for (int t = tid; t < C; t += nt) {
      float bb = 0.f, dbb = 0.f;
      for (int kk = 0; kk < K; ++kk)
        bb = fmaf(rs[t * K + kk] * us[kk], ks[t * ldk + kk], bb);
      for (int vv = 0; vv < V; ++vv)
        dbb = fmaf(dys[t * V + vv], vs[t * ldv + vv], dbb);
      bon[t] = bb;
      db[t] = dbb;
    }
    for (int idx = tid; idx < ck; idx += nt) {
      const int i = idx / K, kk = idx - i * K;
      kd[idx] = ks[i * ldk + kk] * expf(tv[kk] - cw[i * ldk + kk]);
    }
    __syncthreads();

    // dv = A^T dy + bonus dy + (k e^{T-cw}) dS'
    for (int idx = tid; idx < C * V; idx += nt) {
      const int i = idx / V, vv = idx - i * V;
      float acc = 0.f;
      for (int t = i + 1; t < C; ++t)
        acc = fmaf(att[t * C + i], dys[t * V + vv], acc);
      acc = fmaf(bon[i], dys[i * V + vv], acc);
      for (int kk = 0; kk < K; ++kk)
        acc = fmaf(kd[i * K + kk], ds[kk * ldv + vv], acc);
      dv[(row0 + i) * V + vv] = acc;
    }
    __syncthreads();

    // dr at (t, kk) and dk at (i, kk) = (t, kk); the log-space terms
    for (int idx = tid; idx < ck; idx += nt) {
      const int t = idx / K, kk = idx - t * K;
      const float cxt = cx[idx], cwt = cw[t * ldk + kk];
      float sdy = 0.f;
      for (int vv = 0; vv < V; ++vv)
        sdy = fmaf(st[kk * ldv + vv], dys[t * V + vv], sdy);
      const float dr_inter = expf(cxt) * sdy;
      float p_r = 0.f;
      for (int i = 0; i < t; ++i) {
        const float e = expf(cxt - cw[i * ldk + kk]);
        p_r = fmaf(datt[t * C + i] * ks[i * ldk + kk], e, p_r);
      }
      const float kt = ks[t * ldk + kk], rt = rs[idx];
      dr[(row0 + t) * K + kk] = dr_inter + p_r + db[t] * us[kk] * kt;
      dcx[idx] = rt * (dr_inter + p_r);

      float p_k = 0.f;
      for (int j = t + 1; j < C; ++j) {
        const float e = expf(cx[j * K + kk] - cwt);
        p_k = fmaf(datt[j * C + t] * rs[j * K + kk], e, p_k);
      }
      float vds = 0.f;
      for (int vv = 0; vv < V; ++vv)
        vds = fmaf(vs[t * ldv + vv], ds[kk * ldv + vv], vds);
      const float dk_state = expf(tv[kk] - cwt) * vds;
      dk[(row0 + t) * K + kk] = p_k + db[t] * us[kk] * rt + dk_state;
      dcw[idx] = -kt * (p_k + dk_state);
      att[idx] = kt * dk_state;         // A is dead after dv
    }
    __syncthreads();

    // per column: dT, dlogw (reverse cumsums), du; all: r e^{cx}
    for (int kk = tid; kk < K; kk += nt) {
      const float et = expf(tv[kk]);
      float s_ds = 0.f;
      for (int vv = 0; vv < V; ++vv)
        s_ds = fmaf(st[kk * ldv + vv], ds[kk * ldv + vv], s_ds);
      float sk = 0.f;
      for (int i = 0; i < C; ++i) sk += att[i * K + kk];
      const float dT = et * s_ds + sk;
      float acc = 0.f;
      for (int t = C - 1; t >= 0; --t) {
        float g = dcw[t * K + kk] + dcx[t * K + kk];
        if (t == C - 1) g += dT;
        acc += g;
        dw[(row0 + t) * K + kk] = acc - dcx[t * K + kk];
      }
      float dsum = 0.f;
      for (int t = 0; t < C; ++t)
        dsum = fmaf(db[t] * rs[t * K + kk], ks[t * ldk + kk], dsum);
      dus[kk] += dsum;
    }
    for (int idx = tid; idx < ck; idx += nt) kd[idx] = rs[idx] * expf(cx[idx]);
    __syncthreads();

    // dS (the state before this chunk) = (r e^{cx})^T dy + diag(e^T) dS'
    for (int idx = tid; idx < K * V; idx += nt) {
      const int kk = idx / V, vv = idx - kk * V;
      float acc = ds[kk * ldv + vv] * expf(tv[kk]);
      for (int t = 0; t < C; ++t)
        acc = fmaf(kd[t * K + kk], dys[t * V + vv], acc);
      ds[kk * ldv + vv] = acc;
    }
    __syncthreads();
  }
  store_tile(ds0 + b * K * V, ds, ldv, K, V);
  for (int kk = tid; kk < K; kk += nt) du[b * K + kk] = dus[kk];
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
// s/chunk, K, V) or NULL. s is a multiple of chunk; chunk, K, V <= 64.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rwkv6_fwd_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* y, void* s_out, void* states,
                                int64_t bh, int64_t s, int chunk, int kdim,
                                int vdim, void* stream) {
  const size_t smem = fwd_smem_floats(chunk, kdim, vdim) * sizeof(float);
  int err = launch_checked((const void*)rwkv6_fwd_kernel, smem);
  if (err != 0) return err;
  rwkv6_fwd_kernel<<<(unsigned)bh, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out,
      (float*)states, s, chunk, kdim, vdim);
  return (int)cudaGetLastError();
}

// dy: (bh, s, V); ds_final, ds0: (bh, K, V); dr, dk, dlogw: (bh, s, K); dv:
// (bh, s, V); du: (bh, K); states as the forward wrote them.
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* states, const void* dy,
                                const void* ds_final, void* dr, void* dk,
                                void* dv, void* dw, void* du, void* ds0,
                                int64_t bh, int64_t s, int chunk, int kdim,
                                int vdim, void* stream) {
  const size_t smem = bwd_smem_floats(chunk, kdim, vdim) * sizeof(float);
  int err = launch_checked((const void*)rwkv6_bwd_kernel, smem);
  if (err != 0) return err;
  rwkv6_bwd_kernel<<<(unsigned)bh, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)states, (const float*)dy,
      (const float*)ds_final, (float*)dr, (float*)dk, (float*)dv, (float*)dw,
      (float*)du, (float*)ds0, s, chunk, kdim, vdim);
  return (int)cudaGetLastError();
}
