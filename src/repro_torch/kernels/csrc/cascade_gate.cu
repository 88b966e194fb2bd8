// Fused confidence gate of the ACE cascade over (T, V) logits, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/cascade_gate.py, cascade_gate (Pallas body
// _kernel) -- the TPU kernel that streams vocab tiles through VMEM with a
// running (max, sum-exp) carried across the sequential vocab grid axis and,
// on the last tile, writes the max-softmax confidence, the route code and
// per-block route counts. Same contract: conf = 1 / max(sum_v exp(x_v - m),
// 1e-30) with m the row max; route 0 (accept) when conf >= hi, 1 (drop) when
// conf < lo, else 2 (escalate); counts[r] = number of rows with route r.
//
// Bound on this card: bytes. Each logit is read once and costs ~4 f32
// operations (max, subtract, exp, add), far below the ~20 operations per
// byte at which the CUDA cores, not HBM, would limit an f32 reduction. The
// design is one CTA of 256 threads per token row (the Pallas grid's
// sequential vocab axis becomes the loop inside the CTA): each thread
// strides over the row with 16-byte loads (4 floats or 8 bf16) when the row
// is 16-byte aligned and V is a multiple of the vector width, scalar loads
// otherwise, keeping its own online (m, s) pair in f32. Four vectors are
// loaded before any is reduced, so a thread keeps 64 bytes in flight. The
// pairs are merged by warp shuffles, then across the 8 warps through shared
// memory. Thread 0 writes conf and the route and adds one to counts[route]
// with an integer atomic, so counts are deterministic; every CTA is a real
// row, so the Pallas kernel's live-row mask is implicit. Columns at or past
// V are never read (masked loads, no padded copy). At T = 1 (the serving
// gate) one CTA reads the whole row and the kernel is bound by latency and
// launch, not by HBM; splitting V across CTAs is later work.
//
// Layouts (all contiguous): logits (T, V) bf16 or f32; conf (T,) f32;
// routes (T,) int32; counts (3,) int32, zeroed here on the same stream
// before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // vectors in flight per thread
constexpr float kNeg = -1e30f;     // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// merge (m2, s2) into (m, s): both sums rescaled to the larger max
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// fold n values into (m, s): one rescale per group, not per value
template <int N>
__device__ __forceinline__ void fold(float& m, float& s, const float (&x)[N]) {
  float mx = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = fmaxf(mx, x[i]);
  const float mn = fmaxf(m, mx);
  float acc = s * expf(m - mn);
#pragma unroll
  for (int i = 0; i < N; ++i) acc += expf(x[i] - mn);
  m = mn;
  s = acc;
}

// 16 bytes of T as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
cascade_gate_kernel(const T* __restrict__ logits, float* __restrict__ conf,
                    int* __restrict__ routes, int* __restrict__ counts,
                    int v, float hi, float lo) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<long long>(row) * v;
  float m = kNeg, s = 0.f;
  if (kVector) {
    constexpr int kN = Vec<T>::kN;
    const int nvec = v / kN;
    int i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
      float buf[kUnroll][kN];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Vec<T>::load(x + static_cast<long long>(i + u * kThreads) * kN,
                     buf[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fold(m, s, buf[u]);
    }
    for (; i < nvec; i += kThreads) {
      float buf[kN];
      Vec<T>::load(x + static_cast<long long>(i) * kN, buf);
      fold(m, s, buf);
    }
  } else {
    for (int i = threadIdx.x; i < v; i += kThreads) {
      const float one[1] = {to_f32(x[i])};
      fold(m, s, one);
    }
  }
  // a thread that read nothing holds (kNeg, 0): it adds 0 to any merge
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float wm[kWarps], ws[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = wm[0];
    s = ws[0];
    for (int w = 1; w < kWarps; ++w) merge(m, s, wm[w], ws[w]);
    const float c = 1.f / fmaxf(s, 1e-30f);
    const int r = c >= hi ? 0 : (c < lo ? 1 : 2);
    conf[row] = c;
    routes[row] = r;
    atomicAdd(counts + r, 1);
  }
}

template <typename T>
int launch(const void* logits, float* conf, int* routes, int* counts, int t,
           int v, float hi, float lo, void* stream_ptr) {
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(counts, 0, 3 * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* x = static_cast<const T*>(logits);
  const bool vector = reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                      v % Vec<T>::kN == 0;
  if (vector)
    cascade_gate_kernel<T, true><<<t, kThreads, 0, stream>>>(
        x, conf, routes, counts, v, hi, lo);
  else
    cascade_gate_kernel<T, false><<<t, kThreads, 0, stream>>>(
        x, conf, routes, counts, v, hi, lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int cascade_gate_bf16(const void* logits, float* conf, int* routes,
                                 int* counts, int t, int v, float hi, float lo,
                                 void* stream) {
  return launch<__nv_bfloat16>(logits, conf, routes, counts, t, v, hi, lo,
                               stream);
}

extern "C" int cascade_gate_f32(const void* logits, float* conf, int* routes,
                                int* counts, int t, int v, float hi, float lo,
                                void* stream) {
  return launch<float>(logits, conf, routes, counts, t, v, hi, lo, stream);
}
