// Cached GQA attention of a T-token chunk (T = 1: one decode token) against
// a paged KV pool addressed through per-slot block tables, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py, paged_decode_attention
// (Pallas body _paged_kernel) -- the TPU kernel whose grid step ik DMAs
// pool block block_tables[b, ik] through a scalar-prefetched index map,
// masks table holes (-1) and skips blocks with no visible key.
//
// Bound on this card: bytes. A decode step reads each live K/V entry of
// the layer once (bf16) plus one position per token of the table's blocks,
// and does ~4 * G flops per K/V element, far below the ~295 flop/byte the
// H100 needs before its tensor cores matter. The design is the ring
// kernel's (decode_attention.cu) with one change: where key j lives. Logical
// key j of slot b is token j % bs of pool block table[b, j / bs]
// (attn::PagedKeys); a hole reads no K/V and has position -1. Each K/V tile
// is read once per (slot, KV head) for all T*G query rows of that head (GQA
// folding), keys no row may see are not read, and tiles with none left are
// not loaded. The logical key axis (M * bs, trailing holes included) is
// split across CTAs, because B * KV is only 24 at 8 slots on 132 SMs: grid
// (B * KV, row tiles of up to 64, splits), and a second kernel merges the
// splits' partials by log-sum-exp.
//
// bf16 (the serving path): mma::decode_cta of attention_mma.cuh on the
// tensor cores. The CTA starts Q's copy, then stages its split's key
// positions and per-key K/V offsets in shared memory once (the table
// lookup is two dependent loads a key, so it is done for all keys of the
// split together, several loads in flight a thread, not per tile), lists
// the tiles some row may see, and streams only those by double-buffered
// cp.async. A warp tile of 32 keys (16 above hd 128) may span several pool
// blocks, or part of one: the staged offsets make that free. The split rule
// is paged_split_len (decode_attention.py): whole warp tiles, at least 256
// keys a split where M * bs has them, at most 2048 staged keys, at most two
// waves. With one split the CTA writes the output and the combine kernel is
// not launched.
//
// f32: the scalar body of attention_tile.cuh on the CUDA cores with the
// wrapper's split_len, as for the ring: tensor cores would take f32 as
// TF32, which the port's f32 checks would not pass.
//
// Layouts (all contiguous): q, out (B, T, H, hd); k, v (N, bs, KV_ROW, hd);
// q_pos (B, T) int32; k_pos (N, bs) int32 with -1 = never written; tables
// (B, M) int32 with -1 = hole; scratch m_part, l_part (B*T*H, splits) and
// acc_part (B*T*H, splits, hd) f32. q, k and v 16-byte aligned. Rows with
// no valid key are written 0. The query heads attend KV heads kv0 .. kv0 +
// kvh_n - 1 of the pool's KV_ROW, as in the ring kernel: a tensor-parallel
// rank's share of KV heads that every rank keeps whole, read in place.
#include "attention_mma.cuh"

using namespace attn;

__device__ __forceinline__ PagedKeys paged_keys(const int* __restrict__ k_pos,
                                                const int* __restrict__ tables,
                                                int b, int kvh, int kv_row,
                                                int kv0, int bs, int m,
                                                int hd) {
  return PagedKeys{tables + static_cast<long long>(b) * m, k_pos, bs,
                   static_cast<long long>(kv_row) * hd,
                   static_cast<long long>(kv0 + kvh) * hd};
}

// -- bf16: tensor cores -------------------------------------------------------

// one CTA per SM is enough (the ring kernel's bound: ptxas may give a
// thread all the registers it needs)
template <int HDMAX>
__global__ void __launch_bounds__(128, 1)
paged_decode_mma_kernel(const mma::bf16* __restrict__ q,
                        const mma::bf16* __restrict__ k,
                        const mma::bf16* __restrict__ v,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos,
                        const int* __restrict__ tables,
                        mma::bf16* __restrict__ out,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ acc_part, int tq, int h,
                        int kvh_n, int kv_row, int kv0, int bs, int m,
                        int hd, int split_len, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / kvh_n, kvh = blockIdx.x - b * kvh_n;
  const PagedKeys keys =
      paged_keys(k_pos, tables, b, kvh, kv_row, kv0, bs, m, hd);
  mma::decode_cta<HDMAX>(smem_raw, q, k, v, q_pos, keys, out, m_part, l_part,
                         acc_part, b, kvh, tq, h, kvh_n, m * bs, hd,
                         split_len, window, scale);
}

template <int HDMAX>
static int launch_mma(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* k_pos, const int* tables,
                      void* out, float* m_part, float* l_part,
                      float* acc_part, int b, int tq, int h, int kvh_n,
                      int kv_row, int kv0, int bs, int m, int hd,
                      int split_len, int window, float scale,
                      cudaStream_t stream) {
  if (split_len % mma::kDecodeWarpKeys<HDMAX>)
    return static_cast<int>(cudaErrorInvalidValue);
  const mma::DecodeGrid d =
      mma::decode_grid<HDMAX>(b, tq, h, kvh_n, m * bs, split_len);
  auto kernel = paged_decode_mma_kernel<HDMAX>;
  cudaError_t err = allow_smem(kernel, d.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<mma::bf16*>(out);
  kernel<<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), q_pos, k_pos, tables, o, m_part,
      l_part, acc_part, tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.nsplit == 1) return static_cast<int>(err);
  combine_kernel<mma::bf16><<<b * tq * h, 64, 0, stream>>>(
      m_part, l_part, acc_part, o, d.nsplit, hd);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0: no sliding window. The logical key axis (m * bs keys per
// slot) is split into ceil(m * bs / split_len) ranges, split_len a multiple
// of the warp tile (32 keys, 16 at hd > 128) and at most 2048; the scratch
// holds that many partials per output row (unused with one range). Returns
// a cudaError_t (0 = every kernel launched).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, const int* tables, void* out, void* m_part,
    void* l_part, void* acc_part, int b, int tq, int h, int kvh_n,
    int kv_row, int kv0, int bs, int m, int hd, int split_len, int window,
    float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mp = static_cast<float*>(m_part), lp = static_cast<float*>(l_part),
       ap = static_cast<float*>(acc_part);
  if (split_len < 1 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_mma<32>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                          tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                          window, scale, st);
  if (hd <= 64)
    return launch_mma<64>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                          tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                          window, scale, st);
  if (hd <= 128)
    return launch_mma<128>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                           tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                           window, scale, st);
  if (hd <= 256)
    return launch_mma<256>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                           tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                           window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- f32: CUDA cores ----------------------------------------------------------

template <int LD>
__global__ void __launch_bounds__(128)
paged_decode_attention_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ k_pos,
                              const int* __restrict__ tables,
                              float* __restrict__ m_part,
                              float* __restrict__ l_part,
                              float* __restrict__ acc_part, int tq, int h,
                              int kvh_n, int kv_row, int kv0, int bs, int m,
                              int hd,
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
  const PagedKeys keys =
      paged_keys(k_pos, tables, b, kvh, kv_row, kv0, bs, m, hd);
  const int lo = split * split_len, hi = min(m * bs, lo + split_len);
  attend<LD>(s, k, v, keys, lo, hi, nrows, hd, /*causal=*/true,
                    window, scale);
  store_split(s, nrows, hd, split, nsplit, m_part, l_part, acc_part);
}

template <int LD>
static int launch_f32(const void* q, const void* k, const void* v,
                      const int* q_pos, const int* k_pos, const int* tables,
                      void* out, float* m_part, float* l_part,
                      float* acc_part, int b, int tq, int h, int kvh_n,
                      int kv_row, int kv0, int bs, int m, int hd,
                      int split_len, int window, float scale,
                      cudaStream_t stream) {
  const int rows = tq * (h / kvh_n);
  const int rb = rows < kMaxRows ? rows : kMaxRows;
  const int nsplit = (m * bs + split_len - 1) / split_len;
  const size_t smem = smem_bytes(rb, hd);
  auto kernel = paged_decode_attention_kernel<LD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * kvh_n, (rows + rb - 1) / rb, nsplit);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_pos, k_pos, tables, m_part, l_part,
      acc_part, tq, h, kvh_n, kv_row, kv0, bs, m, hd, rb, split_len, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<float><<<b * tq * h, 64, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<float*>(out), nsplit, hd);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0: no sliding window. The logical key axis is split into
// ceil(m * bs / split_len) ranges; the scratch holds that many partials per
// output row. Returns a cudaError_t (0 = both kernels launched).
extern "C" int paged_decode_attention_f32(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, const int* tables, void* out, void* m_part,
    void* l_part, void* acc_part, int b, int tq, int h, int kvh_n,
    int kv_row, int kv0, int bs, int m, int hd, int split_len, int window,
    float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto mp = static_cast<float*>(m_part), lp = static_cast<float*>(l_part),
       ap = static_cast<float*>(acc_part);
  if (split_len < 1 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_f32<1>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                         tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                         window, scale, st);
  if (hd <= 64)
    return launch_f32<2>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                         tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                         window, scale, st);
  if (hd <= 128)
    return launch_f32<4>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                         tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                         window, scale, st);
  if (hd <= 256)
    return launch_f32<8>(q, k, v, q_pos, k_pos, tables, out, mp, lp, ap, b,
                         tq, h, kvh_n, kv_row, kv0, bs, m, hd, split_len,
                         window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
