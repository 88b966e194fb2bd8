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
// over 3.35 TB/s. The channels are independent but time is a chain, and at
// the serving shape (B = 1, W = 4096) one thread per channel walking all S
// steps gives 32 CTAs on 132 SMs. So time is cut into chunks of at most
// kMaxChunk steps, one CTA per (batch row, 128-channel tile, chunk), and
// the chunks of a chain (batch row, channel tile) are joined in one launch
// by a chained scan with look-back, so that a and b are read from HBM once
// (the three-pass scan this replaces read them twice: 20 bytes an element,
// not 12):
//   1. A CTA draws a ticket from a global counter: tickets go out in the
//      order CTAs start, chunk-major, so every chunk a CTA waits for below
//      has started before it and waits only on earlier ones (no deadlock,
//      whatever order the hardware schedules the grid in).
//   2. It copies its chunk of a and b into shared memory by cp.async
//      (16-byte copies where W allows) and composes each channel's steps
//      into one affine map h -> A * h + H.
//   3. The chunks of a chain form groups of `group`. A chunk other than its
//      group's last publishes its map with an "aggregate" flag; the last
//      chunk of a group publishes instead the state after it, with an
//      "inclusive" flag.
//   4. Chunk r of group g starts from the state after group g - 1 (h0 for
//      group 0) and applies the maps of chunks 0 .. r - 1 of its group, in
//      that order: warp 0 waits until those r + 1 flags are up, one lane
//      each. The order is fixed, so the scan gives the same bits on every
//      call (the engine's K = 4 and K = 1 streams depend on that). A
//      decoupled look-back that composes the maps it finds newest first
//      rounds differently wherever it stops, and did change a greedy token
//      of the hybrid; one that applies them to a state oldest first keeps
//      the bits but read more maps and was slower on the H100 (PERF.md).
//   5. It scans its chunk from that state, h = a * h + b step by step (the
//      plain version's arithmetic), into shared memory; a group's last
//      chunk publishes its last h; then the CTA writes every h, and the
//      chain's last chunk h_last.
// The serial part is one link per group (S / (32 * group) links of ~3
// dependent L2 round trips); the rest overlaps across CTAs, ~6 resident a
// SM (32 KB of shared memory each, few registers).
// Publishing: every thread writes its values, then __threadfence and a
// barrier, then one release store of the flag; readers acquire the flag
// and read the values through L2. Flags carry an epoch (flag = epoch << 2 |
// kind) that the launch's last CTA advances, together with resetting the
// ticket counter, so a flag left by an earlier launch is never taken for
// this one's and no scratch is cleared between calls.
//
// Reverse mode (rglru_scan_bwd_f32, the training path's gradient; it
// replaces no TPU kernel: repro differentiates rglru_scan_ref with JAX
// autodiff, src/repro/models/recurrent.py): with g the gradient of the
// running state, g_t = dh_t + a_{t+1} g_{t+1} from g_S = dh_last (a_S = 1)
// is the same recurrence run backward in time with a shifted by one step.
// The same kernel body runs it (kRev): chunk k of a chain covers the k-th
// chunk counted from the end, a row of it is one step earlier in time than
// the row before, and it loads a_{t+1} and dh_t where the forward loads a_t
// and b_t. The tickets, the groups, the fixed-order look-back and the
// scratch protocol (ctl, flags, vals) are the forward's, so one launch of
// either mode leaves the scratch ready for the next launch of either mode
// on that stream. Its epilogue writes db_t = g_t and da_t = g_t h_{t-1}
// (h_{-1} = h0, reading the forward's states), and the chain's last chunk
// dh0 = a_0 g_0: the whole gradient is one launch. Bytes: a, dh and h read,
// da and db written, 20 per element.
//
// Layouts (all contiguous): a, b, h (B, S, W); h0, h_last (B, W). Scratch:
// ctl (3 x u32: ticket, retired CTAs, epoch) and flags (one u32 per CTA),
// both zeroed once by their owner and kept across calls on one stream;
// vals (2 x CTAs x 128 f32: A and H, or the state, per channel),
// uninitialised.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // channels per CTA
constexpr int kMaxChunk = 32;     // steps per chunk at most: shared memory
constexpr int kMaxGroup = 32;     // chunks per group at most: warp 0's lanes
constexpr int kCompose = 8;       // predecessors' maps loaded ahead
constexpr unsigned kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; read = false writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool read) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(read ? 4 : 0));
}

// Make this CTA's values visible device-wide, then publish its flag.
__device__ __forceinline__ void publish(unsigned* flag, unsigned v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, v);
}

// kVec: W % 4 == 0 and a, b, h 16-byte aligned, so a warp moves 512
// contiguous bytes of one step per instruction (thread t: step t / 32 + 4 i,
// channels 4 (t % 32) ..); else thread t moves channel t of every step.
// kRev: the reverse mode (see the header): b is dh, h0 is dh_last, h_out
// takes db and h_last dh0; hf and hf0 are the forward's h and h0, da takes
// da. The forward passes null for those three.
template <bool kVec, bool kRev>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h_out,
                  float* __restrict__ h_last, unsigned* __restrict__ ctl,
                  unsigned* __restrict__ flags, float* __restrict__ vals,
                  const float* __restrict__ hf,
                  const float* __restrict__ hf0, float* __restrict__ da,
                  int s, int w, int chunk, int group, int chains,
                  int nchunks) {
  __shared__ __align__(16) float sa[kMaxChunk][kThreads];
  __shared__ __align__(16) float sh[kMaxChunk][kThreads];  // b, then h
  __shared__ unsigned sh_ticket, sh_epoch;
  if (threadIdx.x == 0) {
    sh_ticket = atomicAdd(&ctl[0], 1u);
    sh_epoch = *reinterpret_cast<volatile unsigned*>(&ctl[2]);
  }
  __syncthreads();
  const int tid = static_cast<int>(threadIdx.x);
  const int ticket = static_cast<int>(sh_ticket);
  const unsigned tag = sh_epoch << 2;
  const int k = ticket / chains, chain = ticket - k * chains;
  const int tiles = (w + kThreads - 1) / kThreads;
  const int row = chain / tiles, c0 = (chain - row * tiles) * kThreads;
  const int nch = min(kThreads, w - c0);       // channels in this tile
  const int t0 = k * chunk, n = min(chunk, s - t0);
  // row u of the chunk is step t0 + u, or in reverse step s - 1 - t0 - u,
  // whose a is read one step later (a_{t+1}; a_S = 1)
  const long long step = kRev ? -static_cast<long long>(w) : w;
  const long long off =
      (static_cast<long long>(row) * s + (kRev ? s - 1 - t0 : t0)) * w + c0;
  const long long a_shift = kRev ? w : 0;
  const bool a_one = kRev && k == 0;           // row 0 holds a_S = 1

  if constexpr (kVec) {
    const int j = (tid & 31) * 4;
    for (int u = tid >> 5; u < n; u += kThreads / 32) {
      const long long i = off + u * step + j;
      const bool rd = j < nch;
      if (a_one && u == 0)
        *reinterpret_cast<float4*>(&sa[0][j]) =
            make_float4(1.f, 1.f, 1.f, 1.f);
      else
        cp_async16(&sa[u][j], rd ? a + i + a_shift : a, rd);
      cp_async16(&sh[u][j], rd ? b + i : b, rd);
    }
  } else {
    const bool rd = tid < nch;
    for (int u = 0; u < n; ++u) {
      const long long i = off + u * step + tid;
      if (a_one && u == 0)
        sa[0][tid] = 1.f;
      else
        cp_async4(&sa[u][tid], rd ? a + i + a_shift : a, rd);
      cp_async4(&sh[u][tid], rd ? b + i : b, rd);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // a chain's chunks are adjacent in flags and vals
  const long long nctas = static_cast<long long>(chains) * nchunks;
  const int base = chain * nchunks;
  float* va = vals;                              // A, or the state
  float* vh = vals + nctas * kThreads;           // H
  const long long me = static_cast<long long>(base + k) * kThreads + tid;
  const int g = k / group, r = k - g * group;
  const bool last_of_group = r == group - 1 || k + 1 == nchunks;

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!last_of_group) {                          // a successor reads it
    float A = 1.f, H = 0.f;
    for (int u = 0; u < n; ++u) {
      H = fmaf(sa[u][tid], H, sh[u][tid]);
      A *= sa[u][tid];
    }
    va[me] = A;
    vh[me] = H;
    publish(&flags[base + k], tag | kAggregate);
  }

  // the state before this chunk: after group g - 1, then chunks g * group
  // .. k - 1 in order
  float h;
  if (g == 0 && r == 0) {
    h = tid < nch ? h0[static_cast<long long>(row) * w + c0 + tid] : 0.f;
  } else {
    const int first = g * group;                 // chunk 0 of the group
    if (tid < 32) {
      // lane i < r: chunk first + i's map; lane 31: the state after
      // chunk first - 1 (none in group 0)
      const int p = tid < r ? first + tid : (tid == 31 ? first - 1 : -1);
      int spins = 0;
      for (;;) {
        bool up = true;
        if (p >= 0) {
          const unsigned f = ld_acquire(&flags[base + p]);
          up = (f & ~3u) == tag && (f & 3u) != 0;
        }
        if (__all_sync(0xffffffffu, up)) break;
        if (++spins > 4) __nanosleep(64);
      }
    }
    __syncthreads();
    const long long ps = static_cast<long long>(base + first) * kThreads +
                         tid;
    h = g == 0 ? (tid < nch ? h0[static_cast<long long>(row) * w + c0 + tid]
                            : 0.f)
               : __ldcg(va + ps - kThreads);
    for (int i0 = 0; i0 < r; i0 += kCompose) {
      float pa[kCompose], ph[kCompose];
#pragma unroll
      for (int u = 0; u < kCompose; ++u) {
        const long long q = ps + static_cast<long long>(i0 + u) * kThreads;
        pa[u] = i0 + u < r ? __ldcg(va + q) : 1.f;
        ph[u] = i0 + u < r ? __ldcg(vh + q) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kCompose; ++u) h = fmaf(pa[u], h, ph[u]);
    }
  }

  // the chunk from that state, step by step, into shared memory
  for (int u = 0; u < n; ++u) {
    h = sa[u][tid] * h + sh[u][tid];
    sh[u][tid] = h;
  }
  if (last_of_group && k + 1 < nchunks) {
    va[me] = h;
    publish(&flags[base + k], tag | kInclusive);
  } else {
    __syncthreads();                             // sh is complete
  }
  // the step before row u's, for da = g h_{t-1}: h_{-1} = h0
  const bool from_h0 = kRev && k + 1 == nchunks;
  const long long first = static_cast<long long>(row) * w + c0;
  if constexpr (kVec) {
    const int j = (tid & 31) * 4;
    if (j < nch)
      for (int u = tid >> 5; u < n; u += kThreads / 32) {
        const long long i = off + u * step + j;
        const float4 g = *reinterpret_cast<const float4*>(&sh[u][j]);
        *reinterpret_cast<float4*>(h_out + i) = g;
        if constexpr (kRev) {
          const float4 p = from_h0 && u == n - 1
              ? *reinterpret_cast<const float4*>(hf0 + first + j)
              : *reinterpret_cast<const float4*>(hf + i - w);
          *reinterpret_cast<float4*>(da + i) =
              make_float4(g.x * p.x, g.y * p.y, g.z * p.z, g.w * p.w);
        }
      }
  } else if (tid < nch) {
    for (int u = 0; u < n; ++u) {
      const long long i = off + u * step + tid;
      h_out[i] = sh[u][tid];
      if constexpr (kRev)
        da[i] = sh[u][tid] *
                (from_h0 && u == n - 1 ? hf0[first + tid] : hf[i - w]);
    }
  }
  if (k + 1 == nchunks && tid < nch) {
    // reverse: dh0 = a_0 g_0, a_0 the chain's first step
    h_last[first + tid] =
        kRev ? a[static_cast<long long>(row) * s * w + c0 + tid] * h : h;
  }
  // the last CTA to retire readies the scratch for the next launch
  if (tid == 0) {
    const unsigned done = atomicAdd(&ctl[1], 1u);
    if (done + 1 == gridDim.x) {
      ctl[0] = 0;
      ctl[1] = 0;
      ctl[2] = sh_epoch + 1;
    }
  }
}

template <bool kVec, bool kRev>
int launch(const float* a, const float* b, const float* h0, float* h,
           float* h_last, unsigned* ctl, unsigned* flags, float* vals,
           const float* hf, const float* hf0, float* da, int s, int w,
           int chunk, int group, int chains, int nchunks,
           cudaStream_t stream) {
  auto kernel = rglru_scan_kernel<kVec, kRev>;
  static bool carved = false;
  if (!carved) {     // all of the SM's shared memory: more CTAs resident
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    carved = true;
  }
  kernel<<<chains * nchunks, kThreads, 0, stream>>>(
      a, b, h0, h, h_last, ctl, flags, vals, hf, hf0, da, s, w, chunk, group,
      chains, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk: steps per time chunk, 1 <= chunk <= 32; group: chunks per
// look-back group, 1 <= group <= 32. The chunk count is ceil(s / chunk) and
// the grid (B * ceil(w / 128) * chunks) CTAs. ctl and flags: see above
// (flags holds at least one entry per CTA); vals: 2 * 128 floats per CTA.
// Returns a cudaError_t (0 = launched).
extern "C" int rglru_scan_f32(const float* a, const float* b, const float* h0,
                              float* h, float* h_last, unsigned* ctl,
                              unsigned* flags, float* vals, int batch, int s,
                              int w, int chunk, int group, void* stream_ptr) {
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch < 1 || s < 1 || w < 1 || chunk < 1 || chunk > kMaxChunk ||
      group < 1 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (s + chunk - 1) / chunk;
  const int chains = batch * ((w + kThreads - 1) / kThreads);
  const bool vec = w % 4 == 0 &&
                   ((reinterpret_cast<unsigned long long>(a) |
                     reinterpret_cast<unsigned long long>(b) |
                     reinterpret_cast<unsigned long long>(h)) & 15) == 0;
  return vec ? launch<true, false>(a, b, h0, h, h_last, ctl, flags, vals,
                                   nullptr, nullptr, nullptr, s, w, chunk,
                                   group, chains, nchunks, stream)
             : launch<false, false>(a, b, h0, h, h_last, ctl, flags, vals,
                                    nullptr, nullptr, nullptr, s, w, chunk,
                                    group, chains, nchunks, stream);
}

// The reverse mode: from a (B, S, W), the forward's states h (B, S, W) and
// h0 (B, W), and the gradients dh (B, S, W) and dh_last (B, W), writes da,
// db (B, S, W) and dh0 (B, W). chunk, group, ctl, flags and vals as for
// rglru_scan_f32 (the same scratch may serve both). Returns a cudaError_t
// (0 = launched).
extern "C" int rglru_scan_bwd_f32(const float* a, const float* h,
                                  const float* h0, const float* dh,
                                  const float* dh_last, float* da, float* db,
                                  float* dh0, unsigned* ctl, unsigned* flags,
                                  float* vals, int batch, int s, int w,
                                  int chunk, int group, void* stream_ptr) {
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch < 1 || s < 1 || w < 1 || chunk < 1 || chunk > kMaxChunk ||
      group < 1 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (s + chunk - 1) / chunk;
  const int chains = batch * ((w + kThreads - 1) / kThreads);
  const bool vec = w % 4 == 0 &&
                   ((reinterpret_cast<unsigned long long>(a) |
                     reinterpret_cast<unsigned long long>(h) |
                     reinterpret_cast<unsigned long long>(h0) |
                     reinterpret_cast<unsigned long long>(dh) |
                     reinterpret_cast<unsigned long long>(da) |
                     reinterpret_cast<unsigned long long>(db)) & 15) == 0;
  return vec ? launch<true, true>(a, dh, dh_last, db, dh0, ctl, flags, vals,
                                  h, h0, da, s, w, chunk, group, chains,
                                  nchunks, stream)
             : launch<false, true>(a, dh, dh_last, db, dh0, ctl, flags, vals,
                                   h, h0, da, s, w, chunk, group, chains,
                                   nchunks, stream);
}
