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
// What bounds it. Each logit is read once and costs ~4 f32 operations (max,
// subtract, exp, add), far below the ~20 operations per byte at which the
// CUDA cores, not HBM, would limit an f32 reduction: at the bulk shape (T in
// the thousands) it is bound by bytes. At the serving gate (T = 1, a 98 KB
// bf16 row the unembed has just left in L2) the bytes take nanoseconds and
// the kernel is bound by latency: the number of dependent memory round trips
// between launch and the last store. One CTA per row would read a
// 49,152-entry row in 6 (bf16) or 12 (f32) dependent rounds of 16 KB and
// then merge on one SM.
//
// The design. The row's V columns are cut into S splits, one CTA each, and
// the S CTAs of a row form one thread-block cluster (grid S x T, cluster
// S x 1). S comes from gate_splits() in kernels/cascade_gate.py: a split
// holds at most one round of loads in flight (256 threads x 4 x 16 B = 16
// KB: 8,192 bf16 or 4,096 f32 entries), S is capped at the portable cluster
// size of 8 (where the row needs more, each thread keeps 8 loads in flight
// rather than 4), and S = 1 once T alone fills about two waves of the SMs
// (no cluster, no barrier: the bulk shape keeps one CTA per row). A thread
// strides over its split with 16-byte loads (4 floats or 8 bf16) when the
// row is 16-byte aligned and V is a multiple of the vector width, scalar
// loads otherwise, issues every load of a round before it reduces any, and
// keeps its own online (m, s) pair in f32, starting from -1e30 (the Pallas
// NEG_INF): a thread or a split that reads nothing, or only -inf, holds
// (-1e30, 0) and adds nothing to a merge. Warp shuffles, then the 8 warps in
// a fixed tree, give the CTA's pair. Each CTA stores it through distributed
// shared memory into rank 0's slot for its rank; after one cluster barrier
// rank 0 merges the slots in rank order, so equal inputs give equal bits
// whichever CTA finishes first (the engines' K = 4 == K = 1 checks depend on
// it). An earlier barrier phase (every CTA has started, so its shared
// memory may be written) is arrived at on entry and waited for after the
// streaming, off the critical path; rank 0 reads nothing remote, so the
// peers exit at once. No partial leaves the chip and there is one launch.
//
// Counts with no memset. The wrapper keeps a persistent 4-int workspace per
// (device, stream): three route accumulators and a row ticket, zeroed once.
// Each row's rank 0 adds its route to its accumulator, fences, and draws a
// ticket; the CTA that draws ticket T - 1 moves the accumulators into
// counts with atomicExch(.., 0), which leaves them zero, and resets the
// ticket, so the next launch on the stream finds the workspace clean. At
// T = 1 the one row writes counts itself and leaves the workspace alone.
// Columns at or past V are never read (masked loads, no padded copy).
//
// Layouts (all contiguous): logits (T, V) bf16 or f32; conf (T,) f32;
// routes (T,) int32; counts (3,) int32, written by the kernel; work (4,)
// int32, zero between launches.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // loads in flight per thread in a round
constexpr int kWideUnroll = 8;     // ... where a split needs more than one
constexpr int kMaxSplits = 8;      // the portable cluster size
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

// The cluster barrier in two halves (PTX barrier.cluster): every thread of
// every CTA of the cluster arrives, then waits for all the others.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One load unit: kN elements of T, held raw until it is folded (so a round
// of bf16 loads costs the registers of a round of f32 loads).
template <typename T, bool kVector> struct Unit;
template <typename T> struct Unit<T, false> {
  static constexpr int kN = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(Raw r, float (&x)[1]) {
    x[0] = to_f32(r);
  }
};
template <> struct Unit<float, true> {
  static constexpr int kN = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&x)[4]) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};
template <> struct Unit<__nv_bfloat16, true> {
  static constexpr int kN = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// The route of one row from its merged (m, s); conf and route written, the
// route counted.
__device__ __forceinline__ void finish(float s, int row, int t, float hi,
                                      float lo, float* conf, int* routes,
                                      int* counts, int* work) {
  const float c = 1.f / fmaxf(s, 1e-30f);
  const int r = c >= hi ? 0 : (c < lo ? 1 : 2);
  conf[row] = c;
  routes[row] = r;
  if (t == 1) {                    // one row: nothing to gather
    counts[0] = r == 0;
    counts[1] = r == 1;
    counts[2] = r == 2;
    return;
  }
  atomicAdd(work + r, 1);
  __threadfence();                 // the add lands before the ticket
  if (atomicAdd(work + 3, 1) == t - 1) {   // every other row has added
    __threadfence();
#pragma unroll
    for (int k = 0; k < 3; ++k) counts[k] = atomicExch(work + k, 0);
    atomicExch(work + 3, 0);
  }
}

// Grid: (T) CTAs with kCluster false; (S, T) in clusters of (S, 1) with
// kCluster true. Split `rank` of row `row` reads columns [rank * split_len,
// min(v, (rank + 1) * split_len)); split_len is a multiple of the unit.
template <typename T, bool kVector, int kU, bool kCluster>
__global__ void __launch_bounds__(kThreads)
cascade_gate_kernel(const T* __restrict__ logits, float* __restrict__ conf,
                    int* __restrict__ routes, int* __restrict__ counts,
                    int* __restrict__ work, int t, int v, int split_len,
                    float hi, float lo) {
  using U = Unit<T, kVector>;
  constexpr int kN = U::kN;
  // shared memory of a cluster's CTAs may be written only once they all
  // run: arrive now, wait just before the first remote store
  if constexpr (kCluster) cluster_arrive_relaxed();
  const int rank = kCluster ? blockIdx.x : 0;
  const int row = kCluster ? blockIdx.y : blockIdx.x;
  const long long begin = static_cast<long long>(rank) * split_len;
  const long long end = begin + split_len < v ? begin + split_len : v;
  const int units = end > begin ? static_cast<int>((end - begin) / kN) : 0;
  const T* x = logits + static_cast<long long>(row) * v + begin;
  float m = kNeg, s = 0.f;
  for (int i0 = threadIdx.x; i0 < units; i0 += kU * kThreads) {
    typename U::Raw buf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < units) buf[u] = U::load(x + static_cast<long long>(i) * kN);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (i0 + u * kThreads < units) {
        float f[kN];
        U::unpack(buf[u], f);
        fold(m, s, f);
      }
    }
  }
  // the CTA's pair: a butterfly within each warp, then one over the warps'
  // pairs in warp 0 (a fixed tree: the same bits on every call)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float wm[kWarps], ws[kWarps];
  __shared__ float2 pairs[kMaxSplits];   // rank 0's: one per split
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? wm[lane] : kNeg;
    s = lane < kWarps ? ws[lane] : 0.f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
  }
  if constexpr (kCluster) {
    // each CTA stores its pair into rank 0's shared memory; one barrier
    // (release, then acquire) makes every pair visible to rank 0, which
    // merges them in rank order; the peers are then done
    cluster_wait();
    if (threadIdx.x == 0)
      cg::this_cluster().map_shared_rank(pairs, 0)[rank] = make_float2(m, s);
    cluster_arrive();
    cluster_wait();
    if (rank != 0) return;
    if (threadIdx.x == 0) {
      const int splits = static_cast<int>(gridDim.x);
      float2 p[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (r < splits) p[r] = pairs[r];
      m = p[0].x;
      s = p[0].y;
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        if (r < splits) merge(m, s, p[r].x, p[r].y);
    }
  }
  if (threadIdx.x == 0)
    finish(s, row, t, hi, lo, conf, routes, counts, work);
}

template <typename T, bool kVector, int kU, bool kCluster>
cudaError_t launch_as(const T* x, float* conf, int* routes, int* counts,
                      int* work, int t, int v, int splits, int split_len,
                      float hi, float lo, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  if constexpr (kCluster) {
    cfg.gridDim = dim3(splits, t, 1);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else {
    cfg.gridDim = dim3(t, 1, 1);
    cfg.attrs = nullptr;
    cfg.numAttrs = 0;
  }
  return cudaLaunchKernelEx(&cfg, cascade_gate_kernel<T, kVector, kU, kCluster>,
                            x, conf, routes, counts, work, t, v, split_len, hi,
                            lo);
}

template <typename T, bool kVector>
cudaError_t launch_units(const T* x, float* conf, int* routes, int* counts,
                         int* work, int t, int v, int splits, int split_len,
                         float hi, float lo, cudaStream_t stream) {
  if (splits == 1)
    return launch_as<T, kVector, kUnroll, false>(
        x, conf, routes, counts, work, t, v, 1, split_len, hi, lo, stream);
  // loads a thread makes in its split: more than one round of kUnroll only
  // where the cap on S forced a longer split
  const int per_thread =
      (split_len / Unit<T, kVector>::kN + kThreads - 1) / kThreads;
  if (per_thread > kUnroll)
    return launch_as<T, kVector, kWideUnroll, true>(
        x, conf, routes, counts, work, t, v, splits, split_len, hi, lo, stream);
  return launch_as<T, kVector, kUnroll, true>(
      x, conf, routes, counts, work, t, v, splits, split_len, hi, lo, stream);
}

template <typename T>
int launch(const void* logits, float* conf, int* routes, int* counts,
           int* work, int t, int v, int splits, int split_len, float hi,
           float lo, void* stream_ptr) {
  if (t < 1 || v < 1 || splits < 1 || splits > kMaxSplits || split_len < 1 ||
      static_cast<long long>(splits) * split_len < v ||
      (splits > 1 && t > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  const T* x = static_cast<const T*>(logits);
  constexpr int kVec = Unit<T, true>::kN;
  const bool vector = reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                      v % kVec == 0 && split_len % kVec == 0;
  const cudaError_t err =
      vector ? launch_units<T, true>(x, conf, routes, counts, work, t, v,
                                     splits, split_len, hi, lo, stream)
             : launch_units<T, false>(x, conf, routes, counts, work, t, v,
                                      splits, split_len, hi, lo, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int cascade_gate_bf16(const void* logits, float* conf, int* routes,
                                 int* counts, int* work, int t, int v,
                                 int splits, int split_len, float hi, float lo,
                                 void* stream) {
  return launch<__nv_bfloat16>(logits, conf, routes, counts, work, t, v,
                               splits, split_len, hi, lo, stream);
}

extern "C" int cascade_gate_f32(const void* logits, float* conf, int* routes,
                                int* counts, int* work, int t, int v,
                                int splits, int split_len, float hi, float lo,
                                void* stream) {
  return launch<float>(logits, conf, routes, counts, work, t, v, splits,
                       split_len, hi, lo, stream);
}
