// Cached GQA attention of a T-token chunk (T = 1: one decode token) against
// a per-slot ring KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention (Pallas
// body _kernel) -- the TPU kernel that streams the ring once per layer and
// folds the G query heads of a KV head into the rows of one tile.
//
// Bound on this card: bytes. Each decode step reads every live cache entry
// of the layer once (K and V, bf16) and does ~4 * G flops per K/V element,
// far below the ~295 flop/byte the H100 needs before its tensor cores
// matter. So the design reads each K/V tile once per (slot, KV head) and
// reuses it across the T*G query rows of that KV head, and never reads the
// tiles of a ring that hold no position any row may see (empty slots, the
// part outside a sliding window). One (slot, KV head) pair alone is a
// serial chain of dependent tile loads, and B * KV is only 24 at 8 slots
// on 132 SMs, so the key axis is also split across CTAs (flash decoding):
// grid (B * KV, row tiles of 64, splits), each CTA writing its partial
// (max, sum, unnormalised P V) to f32 scratch, and a second kernel
// combines the splits by log-sum-exp.
//
// Layouts (all contiguous): q, out (B, T, H, hd); k, v (B, W, KV, hd);
// q_pos (B, T) int32; k_pos (B, W) int32 with -1 = empty slot; scratch
// m_part, l_part (B*T*H, splits) and acc_part (B*T*H, splits, hd) f32.
// Rows with no valid key are written as 0.
#include "attention_tile.cuh"

using namespace attn;

template <typename T, int LD>
__global__ void __launch_bounds__(128)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part, int tq, int h,
                        int kvh_n, int w, int hd, int rows_per_cta,
                        int split_len, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / kvh_n, kvh = blockIdx.x - b * kvh_n;
  const int g = h / kvh_n, rows = tq * g;
  const int row0 = blockIdx.y * rows_per_cta;
  const int nrows = min(rows_per_cta, rows - row0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const Smem s = carve(smem_raw, rows_per_cta, hd);
  // row i of a KV head = token i / G, query head kvh * G + i % G
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int gr = row0 + r, t = gr / g, head = kvh * g + (gr - t * g);
    s.roff[r] = ((static_cast<long long>(b) * tq + t) * h + head) * hd;
    s.qpos[r] = q_pos[static_cast<long long>(b) * tq + t];
  }
  load_rows<T>(s, q, nrows, hd);
  const long long stride = static_cast<long long>(kvh_n) * hd;
  const long long base =
      static_cast<long long>(b) * w * stride + static_cast<long long>(kvh) * hd;
  const int lo = split * split_len, hi = min(w, lo + split_len);
  const StridedKeys keys{base, stride, k_pos + static_cast<long long>(b) * w};
  attend<T, LD>(s, k, v, keys, lo, hi, nrows, hd, /*causal=*/true, window,
                scale);
  store_split(s, nrows, hd, split, nsplit, m_part, l_part, acc_part);
}

template <typename T, int LD>
static int launch(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* k_pos, void* out,
                  float* m_part, float* l_part, float* acc_part, int b,
                  int tq, int h, int kvh_n, int w, int hd, int split_len,
                  int window, float scale, cudaStream_t stream) {
  const int rows = tq * (h / kvh_n);
  const int rb = rows < kMaxRows ? rows : kMaxRows;
  const int nsplit = (w + split_len - 1) / split_len;
  const size_t smem = smem_bytes(rb, hd);
  auto kernel = decode_attention_kernel<T, LD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * kvh_n, (rows + rb - 1) / rb, nsplit);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, m_part, l_part, acc_part, tq,
      h, kvh_n, w, hd, rb, split_len, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<T><<<b * tq * h, 64, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(out), nsplit, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v,
                    const int* q_pos, const int* k_pos, void* out,
                    void* m_part, void* l_part, void* acc_part, int b,
                    int tq, int h, int kvh_n, int w, int hd, int split_len,
                    int window, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mp = static_cast<float*>(m_part), lp = static_cast<float*>(l_part),
       ap = static_cast<float*>(acc_part);
  if (split_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch<T, 1>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                        kvh_n, w, hd, split_len, window, scale, st);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                        kvh_n, w, hd, split_len, window, scale, st);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                        kvh_n, w, hd, split_len, window, scale, st);
  if (hd <= 256)
    return launch<T, 8>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                        kvh_n, w, hd, split_len, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// window <= 0: no sliding window. Keys are split into ceil(w / split_len)
// ranges; the scratch holds that many partials per output row. Returns a
// cudaError_t (0 = both kernels launched).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     const int* k_pos, void* out,
                                     void* m_part, void* l_part,
                                     void* acc_part, int b, int tq, int h,
                                     int kvh_n, int w, int hd, int split_len,
                                     int window, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, q_pos, k_pos, out, m_part, l_part,
                                 acc_part, b, tq, h, kvh_n, w, hd, split_len,
                                 window, scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const int* q_pos,
                                    const int* k_pos, void* out,
                                    void* m_part, void* l_part,
                                    void* acc_part, int b, int tq, int h,
                                    int kvh_n, int w, int hd, int split_len,
                                    int window, float scale, void* stream) {
  return dispatch<float>(q, k, v, q_pos, k_pos, out, m_part, l_part,
                         acc_part, b, tq, h, kvh_n, w, hd, split_len, window,
                         scale, stream);
}
