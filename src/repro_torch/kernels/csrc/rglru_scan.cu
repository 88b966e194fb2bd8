// RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t over time, for
// Hopper (sm_90a): the port's recurrent prefill.
//
// Replaces: src/repro/kernels/rglru_scan.py, rglru_scan (Pallas body
// _kernel) -- the TPU kernel that walks time tiles in sequence with the
// carry in VMEM, solves each (time tile x 128-channel) tile with a
// Hillis-Steele doubling scan and pads ragged edges with identity steps.
// Same contract: a, b (B, S, W) f32 and h0 (B, W) f32 give every state
// h (B, S, W) f32 and the last one h_last (B, W) f32, for any S, W >= 1.
//
// Bound on this card: bytes. Each element costs one FMA against 12 bytes
// (a and b read, h written), so HBM sets the floor: 12 * B * S * W bytes
// over 3.35 TB/s. The trap is parallelism: the channels are independent but
// time is a chain, and at the serving shape (B = 1, W = 4096) one thread
// per channel walking all S steps gives 32 CTAs of 128 threads on 132 SMs,
// each with one dependent load -> FMA chain in flight. So the time axis is
// split into chunks as well (reduce, then scan, like the decode kernel's
// key split plus combine), three launches on one stream:
//   1. rglru_chunk_reduce: one CTA per (128-channel tile, time chunk,
//      batch row). Each thread composes its channel's steps in the chunk
//      into one affine map h -> A * h + H (A the product of a, H the chunk
//      scanned from h = 0) and writes (A, H) to scratch. No h is written.
//   2. rglru_chunk_carry: one thread per (batch row, channel) walks the
//      chunks in order from h0, writing each chunk's incoming state.
//   3. rglru_chunk_scan: the grid of pass 1 scans each chunk again from
//      its incoming state, h = a * h + b step by step (the plain version's
//      arithmetic), writing every h and, in the last chunk, h_last.
// The wrapper picks the chunk length so the grid holds ~8 CTAs per SM; a
// single chunk skips passes 1 and 2 (h0 is then the incoming state). In
// every pass a thread's loads are coalesced across the warp's channels,
// and kUnroll steps of a and b are loaded before the dependent FMAs run.
// Passes 1 and 3 both read a and b, so the traffic is 20 bytes per element
// against the bound's 12 (pass 3's reads often hit L2 at prefill sizes).
//
// Layouts (all contiguous): a, b, h (B, S, W); h0, h_last (B, W); scratch
// red_a, red_h, carry (B, C, W) for C chunks of `chunk` steps (the last
// chunk may be shorter).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per CTA
constexpr int kUnroll = 8;      // steps of a and b loaded ahead of the FMAs

// Compose steps [t0, t1) of one channel into (A, H): h_out = A * h_in + H.
__device__ __forceinline__ void reduce_steps(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             long long off, int w, int t0,
                                             int t1, float& A, float& H) {
  A = 1.f;
  H = 0.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = off + static_cast<long long>(t + u) * w;
      ra[u] = __ldg(a + i);
      rb[u] = __ldg(b + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      H = ra[u] * H + rb[u];
      A *= ra[u];
    }
  }
  for (; t < t1; ++t) {
    const long long i = off + static_cast<long long>(t) * w;
    const float at = __ldg(a + i);
    H = at * H + __ldg(b + i);
    A *= at;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_chunk_reduce(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ red_a, float* __restrict__ red_h,
                   int s, int w, int chunk) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const int k = blockIdx.y, nchunks = gridDim.y, row = blockIdx.z;
  const int t0 = k * chunk, t1 = min(s, t0 + chunk);
  float A, H;
  reduce_steps(a, b, static_cast<long long>(row) * s * w + c, w, t0, t1, A,
               H);
  const long long o = (static_cast<long long>(row) * nchunks + k) * w + c;
  red_a[o] = A;
  red_h[o] = H;
}

__global__ void __launch_bounds__(kThreads)
rglru_chunk_carry(const float* __restrict__ red_a,
                  const float* __restrict__ red_h,
                  const float* __restrict__ h0, float* __restrict__ carry,
                  int w, int nchunks) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const int row = blockIdx.y;
  const long long base = static_cast<long long>(row) * nchunks * w + c;
  float h = h0[static_cast<long long>(row) * w + c];
  int k = 0;
  for (; k + kUnroll <= nchunks; k += kUnroll) {
    float ra[kUnroll], rh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = __ldg(red_a + base + static_cast<long long>(k + u) * w);
      rh[u] = __ldg(red_h + base + static_cast<long long>(k + u) * w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry[base + static_cast<long long>(k + u) * w] = h;
      h = ra[u] * h + rh[u];
    }
  }
  for (; k < nchunks; ++k) {
    const long long i = base + static_cast<long long>(k) * w;
    carry[i] = h;
    h = red_a[i] * h + red_h[i];
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_chunk_scan(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ carry, float* __restrict__ h_out,
                 float* __restrict__ h_last, int s, int w, int chunk) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= w) return;
  const int k = blockIdx.y, nchunks = gridDim.y, row = blockIdx.z;
  const int t0 = k * chunk, t1 = min(s, t0 + chunk);
  const long long off = static_cast<long long>(row) * s * w + c;
  float h = carry[(static_cast<long long>(row) * nchunks + k) * w + c];
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = off + static_cast<long long>(t + u) * w;
      ra[u] = __ldg(a + i);
      rb[u] = __ldg(b + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = ra[u] * h + rb[u];
      h_out[off + static_cast<long long>(t + u) * w] = h;
    }
  }
  for (; t < t1; ++t) {
    const long long i = off + static_cast<long long>(t) * w;
    h = __ldg(a + i) * h + __ldg(b + i);
    h_out[i] = h;
  }
  if (k == nchunks - 1) h_last[static_cast<long long>(row) * w + c] = h;
}

}  // namespace

// chunk: steps per time chunk (>= 1); the chunk count is ceil(s / chunk).
// With one chunk the scratch pointers are not read and may be null.
// Returns a cudaError_t (0 = launched).
extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0,
                              float* h, float* h_last, float* red_a,
                              float* red_h, float* carry, int batch, int s,
                              int w, int chunk, void* stream_ptr) {
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch < 1 || s < 1 || w < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (s + chunk - 1) / chunk;
  const int tiles = (w + kThreads - 1) / kThreads;
  const dim3 grid(tiles, nchunks, batch);
  const float* incoming = h0;            // one chunk: h0 is its carry
  if (nchunks > 1) {
    rglru_chunk_reduce<<<grid, kThreads, 0, stream>>>(a, b, red_a, red_h, s,
                                                      w, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rglru_chunk_carry<<<dim3(tiles, batch), kThreads, 0, stream>>>(
        red_a, red_h, h0, carry, w, nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    incoming = carry;
  }
  rglru_chunk_scan<<<grid, kThreads, 0, stream>>>(a, b, incoming, h, h_last,
                                                  s, w, chunk);
  return static_cast<int>(cudaGetLastError());
}
