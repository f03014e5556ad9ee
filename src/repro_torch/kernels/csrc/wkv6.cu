// wkv6.cu — the RWKV6 (Finch) WKV recurrence, chunked, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/wkv6.py::wkv6, the Pallas TPU kernel
// (`_kernel`) that carries an fp32 (N, N) state in VMEM scratch across a
// sequential chunk grid axis.
//
// Computes, for r, k, v, w (B, T, H, N) of one dtype (fp32 or bf16), the
// bonus u (H, N) fp32 and an incoming state S0 (B, H, N, N) fp32 (or none:
// zeros), the recurrence
//   y_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// in the chunked linear-attention form of ref.wkv6_chunked_ref: for each
// chunk of C rows, with lw = log(max(w, 1e-12)), incl = cumsum(lw) and
// excl = incl - lw over the chunk, total = incl[C-1],
//   y = (r * exp(excl)) @ S + A @ v + diag(r . u . k) v,
//   A[t, j] = sum_n r[t,n] k[j,n] exp(clip(excl[t,n] - incl[j,n], -60, 0)), j < t,
//   S' = exp(total) * S + (k * exp(clip(total - incl, -60, 0)))^T @ v.
// y has the inputs' dtype; the state leaves in fp32.  Decay ratios are
// exps of clipped non-positive log-space differences: the factorized
// exp(excl) * exp(-incl) form overflows under strong decay.
//
// Bound on this card, at the rwkv6-7b prefill shape (B, T, H, N) =
// (8, 512, 64, 64) in bf16: r, k, v, w in and y out are 5 x 33.55 MB, the
// state in and out 2 x 8.39 MB: 184.5 MB, 0.055 ms at 3.35 TB/s.  The
// recurrence's own work, 4*B*T*H*N^2 = 4.3 GFLOP, is far below that at any
// peak.  This kernel does more: the (C, C, N) decay term of A costs one
// expf per (t, j < t, n), C*(C-1)/2*N = 129 K per chunk at C = N = 64, on
// the fp32 CUDA cores and the special-function units.  So the kernel is
// bound by that arithmetic, not by bytes.
//
// Design: one thread block per (b, h).  A loop over the T/C chunks inside
// the block takes the place of the TPU's sequential chunk grid axis, and
// the fp32 state stays in shared memory across the loop (16 KB at N = 64).
// Per chunk the block stages r, k, v and log w for its C rows in shared
// memory as fp32, forms incl/excl by one sequential prefix sum per key
// channel, builds A with one warp per row t (lanes over j, so the row's r
// and excl are broadcast reads and the k/incl rows, padded to N + 1 floats,
// fall in distinct banks), folds the bonus into A's diagonal, scales r by
// exp(excl) and k by its decay to the chunk's end in place, and then forms
// y (each thread one (t, m) entry: a dot over n against S and over j <= t
// against v) and the new state (each thread one (n, m) entry).  At
// C = N = 64 that is 115,200 bytes of dynamic shared memory: two blocks
// per SM.  No mma/wgmma, factorised decay or TMA yet: that is later work.
//
// The state pointers may alias: each block reads its own (b, h) slice of
// S0 into shared memory before any of its threads writes that slice of the
// output, and no other block touches it.  So the caller may pass the same
// tensor (a layer's slice of the serving cache) as input and output.
//
// Build without --use_fast_math: the decay path needs IEEE expf and logf.
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libwkv6.so wkv6.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// clip to [-60, 0] as jnp.clip / torch.clamp do, NaN passing through
__device__ __forceinline__ float clip_decay(float x) {
  return x < -60.0f ? -60.0f : (x > 0.0f ? 0.0f : x);
}

template <int N>
constexpr size_t smem_floats(int C) {
  // r, v, excl: [C][N]; k, incl: [C][N+1]; S: [N][N]; A: [C][C]
  return 3 * (size_t)C * N + 2 * (size_t)C * (N + 1) + (size_t)N * N +
         (size_t)C * C;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* s_in, float* s_out,
            T* __restrict__ y, int T_len, int H, int C) {
  constexpr int NP = N + 1;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;            // [C][N]   r, then r * exp(excl)
  float* vs = rs + C * N;      // [C][N]   v
  float* ex = vs + C * N;      // [C][N]   log w, then excl
  float* ks = ex + C * N;      // [C][N+1] k, then k * exp(clip(total - incl))
  float* in = ks + C * NP;     // [C][N+1] incl
  float* S = in + C * NP;      // [N][N]   the carried state
  float* A = S + N * N;        // [C][C]   intra-chunk weights, bonus on the diagonal

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_stride = (size_t)H * N;  // between consecutive t
  const size_t base = ((size_t)b * T_len * H + h) * N;
  const float* ub = u + (size_t)h * N;

  // the block's slice of the incoming state, read before anything is written
  if (s_in != nullptr) {
    const float* sb = s_in + (size_t)bh * N * N;
    for (int i = tid; i < N * N; i += kThreads) S[i] = sb[i];
  } else {
    for (int i = tid; i < N * N; i += kThreads) S[i] = 0.0f;
  }

  for (int c0 = 0; c0 < T_len; c0 += C) {
    __syncthreads();  // the previous chunk is consumed (and S is staged)

    // 1. stage the chunk's rows as fp32
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const size_t off = base + (size_t)(c0 + t) * row_stride + n;
      rs[i] = to_float(r[off]);
      vs[i] = to_float(v[off]);
      ks[t * NP + n] = to_float(k[off]);
      const float wf = to_float(w[off]);
      ex[i] = logf(wf < 1e-12f ? 1e-12f : wf);
    }
    __syncthreads();

    // 2. incl = cumsum(lw), excl = incl - lw: one thread per key channel
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float lw = ex[t * N + n];
        acc += lw;
        in[t * NP + n] = acc;
        ex[t * N + n] = acc - lw;
      }
    }
    __syncthreads();

    // 3. A[t, j < t] from the clipped log-space decay differences, and the
    //    bonus r_t . u . k_t on the diagonal: one warp per row t
    for (int t = warp; t < C; t += kWarps) {
      const float* rt = rs + t * N;
      const float* et = ex + t * N;
      for (int j = lane; j < C; j += 32) {
        float a = 0.0f;
        if (j < t) {
          const float* kj = ks + j * NP;
          const float* ij = in + j * NP;
#pragma unroll 8
          for (int n = 0; n < N; ++n)
            a = fmaf(rt[n] * kj[n], expf(clip_decay(et[n] - ij[n])), a);
        } else if (j == t) {
          const float* kt = ks + t * NP;
#pragma unroll 8
          for (int n = 0; n < N; ++n) a = fmaf(rt[n] * __ldg(ub + n), kt[n], a);
        }
        A[t * C + j] = a;
      }
    }
    __syncthreads();

    // 4. in place: r <- r * exp(excl), k <- k * exp(clip(total - incl))
    const float* tot = in + (C - 1) * NP;
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      rs[i] *= expf(ex[i]);
      ks[t * NP + n] *= expf(clip_decay(tot[n] - in[t * NP + n]));
    }
    __syncthreads();

    // 5. y = (r * exp(excl)) @ S + A @ v  (A holds the bonus on j == t)
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N;
      const int m = i - t * N;
      const float* qt = rs + t * N;
      float acc = 0.0f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc = fmaf(qt[n], S[n * N + m], acc);
      const float* at = A + t * C;
      for (int j = 0; j <= t; ++j) acc = fmaf(at[j], vs[j * N + m], acc);
      y[base + (size_t)(c0 + t) * row_stride + m] = from_float<T>(acc);
    }
    __syncthreads();  // every read of S for this chunk's y is done

    // 6. S = exp(total) * S + (decayed k)^T @ v
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N;
      const int m = i - n * N;
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < C; ++j) acc = fmaf(ks[j * NP + n], vs[j * N + m], acc);
      S[i] = expf(tot[n]) * S[i] + acc;
    }
  }
  __syncthreads();

  float* so = s_out + (size_t)bh * N * N;
  for (int i = tid; i < N * N; i += kThreads) so[i] = S[i];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s_in, float* s_out, void* y, int B,
           int T_len, int H, int C, cudaStream_t stream) {
  static bool attr_set = false;  // the opt-in above 48 KB, once per variant
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats<N>(kMaxChunk) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const size_t bytes = smem_floats<N>(C) * sizeof(float);
  wkv6_kernel<T, N><<<(unsigned)(B * H), kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s_in, s_out,
      static_cast<T*>(y), T_len, H, C);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(const void* r, const void* k, const void* v, const void* w,
               const float* u, const float* s_in, float* s_out, void* y,
               int B, int T_len, int H, int N, int C, cudaStream_t st) {
  switch (N) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s_in, s_out, y, B, T_len, H, C, st);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s_in, s_out, y, B, T_len, H, C, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s_in, s_out, y, B, T_len, H, C, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16 (of
// r, k, v, w and y).  u: (H, N) fp32.  s_in: (B, H, N, N) fp32 or null
// (zeros); s_out: (B, H, N, N) fp32, which may be s_in itself.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take (N outside
// {16, 32, 64}, a chunk outside [1, 64] or not dividing T, B*H blocks too
// many).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s_in,
                           void* s_out, void* y, int B, int T_len, int H,
                           int N, int C, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || C < 1 || C > kMaxChunk ||
      T_len % C != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(r, k, v, w, uf, si, so, y, B, T_len, H, N, C, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(r, k, v, w, uf, si, so, y, B, T_len, H,
                                     N, C, st);
  return (int)cudaErrorInvalidValue;
}
