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
// serial chain of tile loads, and B * KV is only 8-24 at 8 slots on 132
// SMs, so the key axis is also split across CTAs (flash decoding): grid
// (B * KV, row tiles of 64, splits), each CTA writing its partial (max,
// sum, unnormalised P V) to f32 scratch, and a second kernel combines the
// splits by log-sum-exp.
//
// bf16 (the serving path): the tensor-core body of attention_mma.cuh. The
// T*G rows of a (slot, KV head) are m16 row tiles (G = 16 fills one;
// smollm's T = 1, G = 3 uses 3 of its 16 rows, which costs nothing in a
// kernel bound by bytes), and a CTA's four warps are its row tiles times
// key groups: at one row tile all four warps take a 32-key tile each of
// every 128-key stage (16-key tiles above hd 128, where a stage of four
// fits twice in shared memory), so a decode step's few rows still keep a
// CTA's warps and its copies busy. Before staging anything the CTA starts
// Q's copy, loads its split's key positions into shared memory and lists
// the tiles some row may see; only those are loaded. The split rule
// (ring_split_len in decode_attention.py) gives each split at least 256
// keys and the grid at most two waves of CTAs, so the f32 partials stay a
// fraction of the K/V bytes (1 MB against 10 MB at recurrentgemma-9b's hd
// 256, where the scalar body's rule wrote 8.4 MB). With one split the CTA
// normalises and writes the output itself and the combine kernel is not
// launched.
//
// f32: the scalar body of attention_tile.cuh on the CUDA cores, with the
// wrapper's split_len. Tensor cores would take f32 as TF32, about three
// decimal digits, which the port's f32 checks (1e-4 against the plain
// version, the 4-layer f32 model against the CPU) would not pass. The dtype
// chooses the variant at the call; both are hand-written, both count as
// launches, and neither stands in for the other when a build or launch
// fails.
//
// Layouts (all contiguous): q, out (B, T, H, hd); k, v (B, W, KV_ROW, hd);
// q_pos (B, T) int32; k_pos (B, W) int32 with -1 = empty slot; scratch
// m_part, l_part (B*T*H, splits) and acc_part (B*T*H, splits, hd) f32.
// q, k and v 16-byte aligned. Rows with no valid key are written as 0.
// The query heads attend KV heads kv0 .. kv0 + kvh_n - 1 of the KV_ROW a
// cache row holds (H / kvh_n query heads each): all of them on one device,
// or a tensor-parallel rank's share of KV heads that every rank keeps whole
// (glm4-9b's 2 over 4 ranks), read in place, without a copy.
#include "attention_mma.cuh"

using namespace attn;

// -- bf16: tensor cores -------------------------------------------------------

// one CTA per SM is enough: ptxas may give a thread all the registers it
// needs (with no minimum it capped the hd-32 ring variant at 72 and spilled)
template <int HDMAX>
__global__ void __launch_bounds__(128, 1)
decode_mma_kernel(const mma::bf16* __restrict__ q,
                  const mma::bf16* __restrict__ k,
                  const mma::bf16* __restrict__ v,
                  const int* __restrict__ q_pos,
                  const int* __restrict__ k_pos, mma::bf16* __restrict__ out,
                  float* __restrict__ m_part, float* __restrict__ l_part,
                  float* __restrict__ acc_part, int tq, int h, int kvh_n,
                  int kv_row, int kv0, int w, int hd, int split_len,
                  int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / kvh_n, kvh = blockIdx.x - b * kvh_n;
  const long long stride = static_cast<long long>(kv_row) * hd;
  const long long base = static_cast<long long>(b) * w * stride +
                         static_cast<long long>(kv0 + kvh) * hd;
  const StridedKeys keys{base, stride, k_pos + static_cast<long long>(b) * w};
  mma::decode_cta<HDMAX>(smem_raw, q, k, v, q_pos, keys, out, m_part, l_part,
                         acc_part, b, kvh, tq, h, kvh_n, w, hd, split_len,
                         window, scale);
}

template <int HDMAX>
static int launch_mma(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* k_pos, void* out,
                      float* m_part, float* l_part, float* acc_part, int b,
                      int tq, int h, int kvh_n, int kv_row, int kv0, int w,
                      int hd, int split_len, int window, float scale,
                      cudaStream_t stream) {
  if (split_len % mma::kDecodeWarpKeys<HDMAX>)
    return static_cast<int>(cudaErrorInvalidValue);
  const mma::DecodeGrid d =
      mma::decode_grid<HDMAX>(b, tq, h, kvh_n, w, split_len);
  auto kernel = decode_mma_kernel<HDMAX>;
  cudaError_t err = allow_smem(kernel, d.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<mma::bf16*>(out);
  kernel<<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), q_pos, k_pos, o, m_part, l_part,
      acc_part, tq, h, kvh_n, kv_row, kv0, w, hd, split_len, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.nsplit == 1) return static_cast<int>(err);
  combine_kernel<mma::bf16><<<b * tq * h, 64, 0, stream>>>(
      m_part, l_part, acc_part, o, d.nsplit, hd);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0: no sliding window. Keys are split into ceil(w / split_len)
// ranges, split_len a multiple of the warp tile (32 keys, 16 at hd > 128);
// the scratch holds that many partials per output row (unused with one
// range).
// Returns a cudaError_t (0 = every kernel launched).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     const int* k_pos, void* out,
                                     void* m_part, void* l_part,
                                     void* acc_part, int b, int tq, int h,
                                     int kvh_n, int kv_row, int kv0, int w,
                                     int hd, int split_len, int window,
                                     float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mp = static_cast<float*>(m_part), lp = static_cast<float*>(l_part),
       ap = static_cast<float*>(acc_part);
  if (split_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_mma<32>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                          kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                          st);
  if (hd <= 64)
    return launch_mma<64>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                          kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                          st);
  if (hd <= 128)
    return launch_mma<128>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                           kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                           st);
  if (hd <= 256)
    return launch_mma<256>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                           kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- f32: CUDA cores ----------------------------------------------------------

template <int LD>
__global__ void __launch_bounds__(128)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part, int tq, int h,
                        int kvh_n, int kv_row, int kv0, int w, int hd,
                        int rows_per_cta, int split_len, int window,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / kvh_n, kvh = blockIdx.x - b * kvh_n;
  const int g = h / kvh_n, rows = tq * g;
  const int row0 = blockIdx.y * rows_per_cta;
  const int nrows = min(rows_per_cta, rows - row0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const Smem s = carve(smem_raw, rows_per_cta, hd);
  decode_rows(s.roff, s.qpos, q_pos, b, kvh, tq, h, g, hd, row0, nrows);
  load_rows(s, q, nrows, hd);
  const long long stride = static_cast<long long>(kv_row) * hd;
  const long long base = static_cast<long long>(b) * w * stride +
                         static_cast<long long>(kv0 + kvh) * hd;
  const int lo = split * split_len, hi = min(w, lo + split_len);
  const StridedKeys keys{base, stride, k_pos + static_cast<long long>(b) * w};
  attend<LD>(s, k, v, keys, lo, hi, nrows, hd, /*causal=*/true,
                    window, scale);
  store_split(s, nrows, hd, split, nsplit, m_part, l_part, acc_part);
}

template <int LD>
static int launch_f32(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* k_pos, void* out,
                      float* m_part, float* l_part, float* acc_part, int b,
                      int tq, int h, int kvh_n, int kv_row, int kv0, int w,
                      int hd, int split_len, int window, float scale,
                      cudaStream_t stream) {
  const int rows = tq * (h / kvh_n);
  const int rb = rows < kMaxRows ? rows : kMaxRows;
  const int nsplit = (w + split_len - 1) / split_len;
  const size_t smem = smem_bytes(rb, hd);
  auto kernel = decode_attention_kernel<LD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * kvh_n, (rows + rb - 1) / rb, nsplit);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, k_pos, m_part, l_part, acc_part,
      tq, h, kvh_n, kv_row, kv0, w, hd, rb, split_len, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<float><<<b * tq * h, 64, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<float*>(out), nsplit, hd);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0: no sliding window. Keys are split into ceil(w / split_len)
// ranges; the scratch holds that many partials per output row. Returns a
// cudaError_t (0 = both kernels launched).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const int* q_pos,
                                    const int* k_pos, void* out,
                                    void* m_part, void* l_part,
                                    void* acc_part, int b, int tq, int h,
                                    int kvh_n, int kv_row, int kv0, int w,
                                    int hd, int split_len, int window,
                                    float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mp = static_cast<float*>(m_part), lp = static_cast<float*>(l_part),
       ap = static_cast<float*>(acc_part);
  if (split_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_f32<1>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                         kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                         st);
  if (hd <= 64)
    return launch_f32<2>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                         kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                         st);
  if (hd <= 128)
    return launch_f32<4>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                         kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                         st);
  if (hd <= 256)
    return launch_f32<8>(q, k, v, q_pos, k_pos, out, mp, lp, ap, b, tq, h,
                         kvh_n, kv_row, kv0, w, hd, split_len, window, scale,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
