// committee_uq.cu -- committee uncertainty statistics for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/committee_uq.py::committee_uq (:116), the
// Pallas TPU kernel (`_kernel`, `pl.pallas_call` at :164) that folds the
// committee axis with a streaming Welford recurrence over a grid
// (n / block_n, K).
//
// Computes, for every row i of preds (K, n, d), contiguous, in fp32, bf16
// or fp16 (each element converted to fp32 as it is loaded, exactly, as the
// reference's `preds.astype(jnp.float32)` does):
//   mean[i, :]        mean over the members whose row i is finite   (n, d) f32
//   scalar_std[i]     max over d of the ddof=1 std                  (n,)   f32
//   component_std[i]  mean over d of the same std                   (n,)   f32
//   finite[i]         members whose row had every component finite  (n,)   i32
//   mask[i]           scalar_std > threshold && finite[i] > 0
//                     [&& i < *n_valid, packed entry]               (n,)   u8
// A member with any non-finite component in row i is left out of row i
// (quarantine); with fewer than 2 finite members the std is 0.
//
// Two entries, one kernel:
//   committee_uq_launch         five separate outputs (the TPU kernel's).
//   committee_uq_packed_launch  the acquisition engine's: the five outputs
//                               written straight into one byte buffer at
//                               the offsets the engine downloads in one copy
//                               (mean, scalar std, component std, finite,
//                               mask), and the engine's whole mask computed
//                               here: n_valid is read through a device
//                               pointer, so the launch takes no host value
//                               that changes between dispatches and a CUDA
//                               graph can replay it.
//
// What bounds it.  At serving sizes (K=4, n=64, d=24: 25 KB in, 7 KB out)
// the launch and one row's chain of memory latencies: on an H100 (700 W)
// an empty one-thread kernel under the same CUDA graph takes ~0.0010 ms,
// this kernel 0.00227 ms, and 0.00254 ms when each member's loads waited
// for the previous member's fold (chip_smoke.py, phase_kernels).  The
// packed entry pays that floor once for the statistics, the row-validity
// and finiteness mask and the packing the engine did before in a dozen
// small kernels (the mask ops and a torch.cat), and it is launched from a
// replayed graph, never from Python.  At large n it is bound by memory
// bandwidth: it reads K*n*d elements and writes n*(d+3)*4 + n bytes, with
// ~6 fp32 operations per element read; at (4, 65536, 24) fp32 it reaches
// 0.29 of that byte bound (0.0327 ms against 0.0096).  One warp owns a
// row, so at d = 24 a warp loads 96 bytes per member-row and 8 of its 32
// lanes stay idle.
//
// Design: one pass and one launch.  One warp owns one row.  Each lane keeps
// the running mean and M2 of up to V = ceil(d/32) components in registers
// while the warp loops over the K members, four members' loads in flight
// at a time, so nothing but the outputs goes back to device memory.  The TPU grid carried this state across a
// sequential K axis; here the loop inside the warp takes its place.  Member
// k joins row i only if every lane agrees its components are finite
// (__all_sync).  The fold is the TPU kernel's recurrence, in the same member
// order:
//   cnt += fin;  delta = fin ? x - mean : 0;  mean += delta / max(cnt, 1);
//   M2 += delta * (fin ? x - mean : 0)
// Rows past n are masked inside the kernel, so the caller makes no padded
// copy.  Lanes past d load nothing and hold zeros.
//
// Build without --use_fast_math: the isfinite tests the quarantine depends
// on, and IEEE division and sqrt, must keep their exact semantics.
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libcommittee_uq.so committee_uq.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) {
  return __half2float(*p);
}

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kMemberGroup = 4;

// Lane's components of one member's row (zeros past d).
template <typename In, int V>
__device__ __forceinline__ void load_member(const In* __restrict__ p,
                                            int lane, int d, float (&x)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + 32 * v;
    x[v] = (c < d) ? load_f32(p + c) : 0.0f;
  }
}

// One Welford step: the member joins the row only if every lane's
// components are finite (the TPU kernel's recurrence, see the note above).
template <int V>
__device__ __forceinline__ void fold(const float (&x)[V], float (&mean)[V],
                                     float (&m2)[V], float& cnt) {
  bool ok = true;
#pragma unroll
  for (int v = 0; v < V; ++v) ok = ok && isfinite(x[v]);
  const bool fin = __all_sync(kFullMask, ok) != 0;
  cnt += fin ? 1.0f : 0.0f;
  const float denom = fmaxf(cnt, 1.0f);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float delta = fin ? x[v] - mean[v] : 0.0f;
    mean[v] = mean[v] + delta / denom;
    m2[v] += delta * (fin ? x[v] - mean[v] : 0.0f);
  }
}

// Where the kernel writes.  n_valid is null for the five-output entry
// (every row valid) and a device int32 for the packed entry.
struct Outputs {
  float* mean;
  float* sstd;
  float* cstd;
  uint8_t* mask;
  int32_t* finite;
  const int32_t* n_valid;
};

template <typename In, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
committee_uq_kernel(const In* __restrict__ preds, int K, int n, int d,
                    float threshold, Outputs out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together

  float mean[V];
  float m2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mean[v] = 0.0f;
    m2[v] = 0.0f;
  }
  float cnt = 0.0f;

  // Members are loaded kMemberGroup at a time, all loads issued before the
  // group is folded: one memory latency per group instead of one per
  // member (at the serving shape the loop is latency-bound).  The fold
  // keeps the member order, so the result does not depend on the grouping.
  const size_t member_stride = (size_t)n * (size_t)d;
  const In* p = preds + (size_t)row * (size_t)d;
  int k = 0;
  for (; k + kMemberGroup <= K; k += kMemberGroup) {
    float x[kMemberGroup][V];
#pragma unroll
    for (int g = 0; g < kMemberGroup; ++g) {
      load_member<In, V>(p + (size_t)g * member_stride, lane, d, x[g]);
    }
    p += kMemberGroup * member_stride;
#pragma unroll
    for (int g = 0; g < kMemberGroup; ++g) fold<V>(x[g], mean, m2, cnt);
  }
  for (; k < K; ++k) {
    float x[V];
    load_member<In, V>(p, lane, d, x);
    p += member_stride;
    fold<V>(x, mean, m2, cnt);
  }

  const float var_denom = fmaxf(cnt - 1.0f, 1.0f);
  float smax = 0.0f;
  float ssum = 0.0f;
  float* mrow = out.mean + (size_t)row * (size_t)d;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = lane + 32 * v;
    if (c < d) {
      const float var = cnt >= 2.0f ? m2[v] / var_denom : 0.0f;
      const float s = sqrtf(var);
      mrow[c] = mean[v];
      smax = fmaxf(smax, s);
      ssum += s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    smax = fmaxf(smax, __shfl_xor_sync(kFullMask, smax, off));
    ssum += __shfl_xor_sync(kFullMask, ssum, off);
  }
  if (lane == 0) {
    const bool valid = out.n_valid == nullptr || row < (long long)*out.n_valid;
    out.sstd[row] = smax;
    out.cstd[row] = ssum / (float)d;
    out.mask[row] = (valid && smax > threshold && cnt > 0.0f) ? 1 : 0;
    out.finite[row] = (int32_t)cnt;
  }
}

template <typename In, int V>
void launch(const void* preds, int K, int n, int d, float threshold,
            const Outputs& out, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  committee_uq_kernel<In, V><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const In*>(preds), K, n, d, threshold, out);
}

template <typename In>
int dispatch_v(const void* p, int K, int n, int d, float threshold,
               const Outputs& o, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: launch<In, 1>(p, K, n, d, threshold, o, st); break;
    case 2: launch<In, 2>(p, K, n, d, threshold, o, st); break;
    case 3: launch<In, 3>(p, K, n, d, threshold, o, st); break;
    case 4: launch<In, 4>(p, K, n, d, threshold, o, st); break;
    case 5: launch<In, 5>(p, K, n, d, threshold, o, st); break;
    case 6: launch<In, 6>(p, K, n, d, threshold, o, st); break;
    case 7: launch<In, 7>(p, K, n, d, threshold, o, st); break;
    case 8: launch<In, 8>(p, K, n, d, threshold, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* preds, int K, int n, int d, float threshold,
             const Outputs& o, int dtype, void* stream) {
  if (K < 1 || n < 1 || d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_v<float>(preds, K, n, d, threshold, o, st);
    case 1:
      return dispatch_v<__nv_bfloat16>(preds, K, n, d, threshold, o, st);
    case 2: return dispatch_v<__half>(preds, K, n, d, threshold, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = fp32, 1 = bf16,
// 2 = fp16 (of preds; the outputs are fp32).  Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take (K < 1, n < 1,
// d < 1 or d > 256, another dtype).

// The five outputs in separate buffers; mask = sstd > threshold && finite.
extern "C" int committee_uq_launch(const void* preds, int K, int n, int d,
                                   float threshold, void* mean, void* sstd,
                                   void* cstd, void* mask, void* finite,
                                   int dtype, void* stream) {
  const Outputs o{static_cast<float*>(mean), static_cast<float*>(sstd),
                  static_cast<float*>(cstd), static_cast<uint8_t*>(mask),
                  static_cast<int32_t*>(finite), nullptr};
  return dispatch(preds, K, n, d, threshold, o, dtype, stream);
}

// The packed entry: ``packed`` holds n*(d+3)*4 + n bytes, laid out as mean
// (n*d f32), scalar std (n f32), component std (n f32), finite (n i32),
// mask (n u8); ``n_valid`` points to one device int32, and rows at or past
// it are masked off.
extern "C" int committee_uq_packed_launch(const void* preds, int K, int n,
                                          int d, float threshold,
                                          const void* n_valid, void* packed,
                                          int dtype, void* stream) {
  float* f = static_cast<float*>(packed);
  const size_t nd = (size_t)n * (size_t)d;
  const Outputs o{f, f + nd, f + nd + n,
                  static_cast<uint8_t*>(packed) + (nd + 3 * (size_t)n) * 4,
                  reinterpret_cast<int32_t*>(f + nd + 2 * (size_t)n),
                  static_cast<const int32_t*>(n_valid)};
  return dispatch(preds, K, n, d, threshold, o, dtype, stream);
}

namespace {
__global__ void noop_kernel() {}
}  // namespace

// One empty one-thread kernel on ``stream``: its device time is the launch
// floor any kernel of this size pays (measured beside committee_uq, which
// sits on it at the serving shape).  Returns cudaGetLastError().
extern "C" int committee_uq_noop(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
