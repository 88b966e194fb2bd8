// Full-sequence GQA flash attention forward (causal or windowed), for
// Hopper (sm_90a): the port's prefill kernel.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (Pallas
// body _kernel). Same contract: queries are right-aligned to keys (query i
// sees keys <= i + Sk - Sq), query head h reads KV head h // G, key tiles
// wholly outside the causal/window band are never visited, and the ragged
// tail is masked.
//
// Bound on this card: at prefill sizes (S <= a few thousand, hd = 64) the
// bytes (q, k, v, out once each) and the bf16 tensor-core flops give
// bounds of the same order, both a few microseconds. This first version is
// FA2-shaped but runs its two products on the CUDA cores in f32 FMA (the
// tensor cores are not used), so it is bound by its own FMA issue rate:
// the design keeps it to the band (one CTA per (batch, q head, 16-query
// tile), looping only over key tiles inside the causal/window band) and
// stages each K/V tile once for 16 query rows. Small query tiles give
// 9 * S / 16 CTAs at smollm's 9 heads, enough to fill the card at prefill
// lengths; the K/V tiles they re-read come from L2. wgmma/TMA is later
// work (see PERF.md).
//
// Layouts (all contiguous): q, out (B, Sq, H, hd); k, v (B, Sk, KV, hd).
// Rows with no valid key (only possible when Sq > Sk) are written as 0.
#include "attention_tile.cuh"

using namespace attn;

constexpr int kQTile = 16;   // query rows per CTA: 4 warps x 4 rows

template <typename T, int LD>
__global__ void __launch_bounds__(128)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int sk, int h, int kvh_n, int hd, int causal,
                       int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kQTile, head = blockIdx.y, b = blockIdx.z;
  const int nrows = min(kQTile, sq - q0);
  const int shift = sk - sq;                  // right-aligned queries
  const Smem s = carve(smem_raw, kQTile, hd);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    s.roff[r] = ((static_cast<long long>(b) * sq + q0 + r) * h + head) * hd;
    s.qpos[r] = q0 + r + shift;
  }
  load_rows<T>(s, q, nrows, hd);
  // the band of keys this query tile can see
  const int first = q0 + shift, last = q0 + nrows - 1 + shift;
  const int hi = causal ? min(sk, last + 1) : sk;
  const int lo = window > 0 ? max(0, first - window + 1) : 0;
  const long long stride = static_cast<long long>(kvh_n) * hd;
  const long long base = static_cast<long long>(b) * sk * stride +
                         static_cast<long long>(head / (h / kvh_n)) * hd;
  const StridedKeys keys{base, stride, nullptr};
  attend<T, LD>(s, k, v, keys, lo, hi, nrows, hd, causal != 0, window,
                scale);
  store_rows<T>(s, out, nrows, hd);
}

template <typename T, int LD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int b, int sq, int sk, int h, int kvh_n, int hd, int causal,
                  int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(kQTile, hd);
  auto kernel = flash_attention_kernel<T, LD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kQTile - 1) / kQTile, h, b);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, h, kvh_n, hd,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* out,
                    int b, int sq, int sk, int h, int kvh_n, int hd,
                    int causal, int window, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, b, sq, sk, h, kvh_n, hd, causal, window,
                        scale, st);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, b, sq, sk, h, kvh_n, hd, causal, window,
                        scale, st);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, b, sq, sk, h, kvh_n, hd, causal, window,
                        scale, st);
  if (hd <= 256)
    return launch<T, 8>(q, k, v, out, b, sq, sk, h, kvh_n, hd, causal, window,
                        scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// window <= 0: no sliding window. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int b, int sq,
                                    int sk, int h, int kvh_n, int hd,
                                    int causal, int window, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, sk, h, kvh_n, hd,
                                 causal, window, scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int sk, int h, int kvh_n, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, out, b, sq, sk, h, kvh_n, hd, causal,
                         window, scale, stream);
}
