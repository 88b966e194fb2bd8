// Full-sequence GQA flash attention forward (causal or windowed), for
// Hopper (sm_90a): the port's prefill kernel.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (Pallas
// body _kernel). Same contract: queries are right-aligned to keys (query i
// sees keys <= i + Sk - Sq), query head h reads KV head h // G, key tiles
// wholly outside the causal/window band are never visited, and the ragged
// tail is masked. Rows with no valid key (only possible when Sq > Sk) are
// written as 0.
//
// Bound on this card: operations at the hybrid's long prefills. Inside the
// band a prefill does 4 * hd flops per (query, key, head) and reads each
// K/V row once per query tile that sees it, far above the ~295 flop/byte
// where the H100's bf16 tensor cores become the limit: recurrentgemma-9b's
// S = 4096, hd 256 prefill is 103 GFLOP in its 2048-key band, 0.10 ms at
// 989 TFLOP/s, while its bytes take 0.03 ms. smollm's 512-token prefill is
// 0.3 GFLOP and 1.6 MB, both under a microsecond: there the longest query
// tile's serial chain of key tiles and the launch set the time.
//
// bf16 (the serving path): the tensor-core body of attention_mma.cuh. One
// CTA of four warps per (batch, query tile, head), launched last query
// tile first (those see the most keys); K/V tiles of 64 keys (32 above 128
// dims) are staged once per CTA by double-buffered cp.async for all its
// warps, and the CTA walks only the key tiles inside its band. The wrapper
// (flash_launch_shape in flash_attention.py) splits the four warps into
// row tiles of 16 queries times key groups: 64 rows when that gives at
// least one CTA per SM (the hybrid's 4096-token prefill: 1,024 CTAs), else
// 32 rows in two key groups (smollm's S = 512 with 9 heads: 144 CTAs whose
// longest chain is four stages of two tiles, not eight tiles), else 16
// rows in four (two above 64 dims). A warp whose rows see none of a tile
// (the diagonal, the window's lower edge) skips it.
//
// f32: the scalar streaming-softmax body of attention_tile.cuh on the CUDA
// cores (one CTA per (batch, q head, 16-query tile)). Tensor cores would
// take f32 as TF32, about three decimal digits, which the port's f32
// checks (1e-4 against the plain version, the 4-layer f32 model against
// the CPU) would not pass. The dtype chooses the variant at the call; both
// are hand-written, both count as launches, and neither stands in for the
// other when a build or launch fails.
//
// Log-sum-exp (training): when the caller passes an lse pointer, each row
// also writes lse = log(sum_j exp(s_j * scale)) over its valid keys in
// natural-log units, f32 (B, Sq, H), -inf for a row with no valid key: the
// statistic flash_attention_bwd.cu rebuilds P from. The serving path
// passes null and writes nothing more.
//
// Layouts (all contiguous): q, out (B, Sq, H, hd); k, v (B, Sk, KV, hd);
// q, k and v 16-byte aligned; lse (B, Sq, H) or null.
#include <math.h>

#include "attention_mma.cuh"

using namespace attn;

// -- bf16: tensor cores -------------------------------------------------------

// keys per warp tile: 64, or 32 above 128 dims, where O takes 128 registers
template <int HDMAX>
constexpr int kWarpKeys = HDMAX <= 128 ? 64 : 32;

// one CTA per SM is enough: ptxas may give a thread all the registers it
// needs (see decode_mma_kernel)
template <int HDMAX>
__global__ void __launch_bounds__(128, 1)
flash_mma_kernel(const mma::bf16* __restrict__ q,
                 const mma::bf16* __restrict__ k,
                 const mma::bf16* __restrict__ v, mma::bf16* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int h, int kvh_n,
                 int hd, int causal, int window, int groups, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KW = kWarpKeys<HDMAX>;
  using S = mma::Shape<HDMAX>;
  const mma::Role role(groups);
  const int rows = role.row_tiles * 16;
  // the last query tiles see the most keys: they are launched first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;
  const int head = blockIdx.y, b = blockIdx.z;
  const int nrows = min(rows, sq - q0);
  const int shift = sk - sq;                  // right-aligned queries
  const mma::Smem s =
      mma::carve(smem_raw, rows, S::kPitch, groups * KW, KW, 0);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    s.roff[r] = ((static_cast<long long>(b) * sq + q0 + r) * h + head) * hd;
    s.qpos[r] = q0 + r + shift;
  }
  __syncthreads();
  mma::load_q<HDMAX>(s, q, nrows, rows, hd);
  // the band of keys this query tile can see
  const int first = q0 + shift, last = q0 + nrows - 1 + shift;
  const int hi = causal ? min(sk, last + 1) : sk;
  const int lo = window > 0 ? max(0, first - window + 1) : 0;
  const int ntiles = hi > lo ? (hi - lo + KW - 1) / KW : 0;
  const long long stride = static_cast<long long>(kvh_n) * hd;
  const long long base = static_cast<long long>(b) * sk * stride +
                         static_cast<long long>(head / (h / kvh_n)) * hd;
  const StridedKeys keys{base, stride, nullptr};
  mma::Acc<HDMAX> acc;
  mma::attend<HDMAX, KW>(s, q, k, v, keys, nrows, hd, lo, hi, nullptr,
                         ntiles, groups, first, last, causal != 0, window,
                         scale, acc);
  mma::store_rows<HDMAX>(s, acc, role, out, nrows, hd);
  if (lse != nullptr && role.group == 0 && (threadIdx.x & 3) == 0) {
    // a group-0 quad's first lane: its two rows' merged (m, l), m in log2
    // units
    for (int r = 0; r < 2; ++r) {
      const int row = role.row0 + ((threadIdx.x & 31) >> 2) + 8 * r;
      if (row < nrows)
        lse[s.roff[row] / hd] = acc.l[r] > 0.f
            ? acc.m[r] * mma::kLn2 + logf(acc.l[r]) : -INFINITY;
    }
  }
}

template <int HDMAX>
static int launch_mma(const void* q, const void* k, const void* v, void* out,
                      float* lse, int b, int sq, int sk, int h, int kvh_n,
                      int hd, int causal, int window, int q_tile, int groups,
                      float scale, cudaStream_t stream) {
  constexpr int KW = kWarpKeys<HDMAX>;
  using S = mma::Shape<HDMAX>;
  const size_t smem =
      mma::smem_bytes(q_tile, S::kPitch, groups * KW, KW, 0);
  auto kernel = flash_mma_kernel<HDMAX>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + q_tile - 1) / q_tile, h, b);
  kernel<<<grid, 2 * q_tile * groups, smem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), static_cast<mma::bf16*>(out), lse,
      sq, sk, h, kvh_n, hd, causal, window, groups, scale);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0: no sliding window; q_tile: query rows per CTA (16, 32 or
// 64); groups: warps that split each query tile's keys (1, 2 or 4, at most
// 2 above 64 dims, q_tile / 16 * groups <= 4 warps); lse: (B, Sq, H) f32
// or null. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    int b, int sq, int sk, int h, int kvh_n,
                                    int hd, int causal, int window,
                                    int q_tile, int groups, float scale,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((q_tile != 16 && q_tile != 32 && q_tile != 64) ||
      (groups != 1 && groups != 2 && groups != 4) ||
      q_tile / 16 * groups > 4 || (hd > 64 && groups > 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_mma<32>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd, causal,
                          window, q_tile, groups, scale, st);
  if (hd <= 64)
    return launch_mma<64>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd, causal,
                          window, q_tile, groups, scale, st);
  if (hd <= 128)
    return launch_mma<128>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd, causal,
                           window, q_tile, groups, scale, st);
  if (hd <= 256)
    return launch_mma<256>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd, causal,
                           window, q_tile, groups, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kQTile = 16;   // query rows per CTA: 4 warps x 4 rows

template <int LD>
__global__ void __launch_bounds__(128)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int h,
                       int kvh_n, int hd, int causal, int window,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kQTile, head = blockIdx.y, b = blockIdx.z;
  const int nrows = min(kQTile, sq - q0);
  const int shift = sk - sq;                  // right-aligned queries
  const Smem s = carve(smem_raw, kQTile, hd);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    s.roff[r] = ((static_cast<long long>(b) * sq + q0 + r) * h + head) * hd;
    s.qpos[r] = q0 + r + shift;
  }
  load_rows(s, q, nrows, hd);
  // the band of keys this query tile can see
  const int first = q0 + shift, last = q0 + nrows - 1 + shift;
  const int hi = causal ? min(sk, last + 1) : sk;
  const int lo = window > 0 ? max(0, first - window + 1) : 0;
  const long long stride = static_cast<long long>(kvh_n) * hd;
  const long long base = static_cast<long long>(b) * sk * stride +
                         static_cast<long long>(head / (h / kvh_n)) * hd;
  const StridedKeys keys{base, stride, nullptr};
  attend<LD>(s, k, v, keys, lo, hi, nrows, hd, causal != 0, window,
                    scale);
  store_rows(s, out, nrows, hd);
  if (lse != nullptr)
    for (int r = threadIdx.x; r < nrows; r += blockDim.x)
      lse[s.roff[r] / hd] =
          s.l[r] > 0.f ? s.m[r] + logf(s.l[r]) : -INFINITY;
}

template <int LD>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      float* lse, int b, int sq, int sk, int h, int kvh_n,
                      int hd, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(kQTile, hd);
  auto kernel = flash_attention_kernel<LD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kQTile - 1) / kQTile, h, b);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk, h,
      kvh_n, hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// window <= 0: no sliding window; lse: (B, Sq, H) f32 or null. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int b, int sq, int sk, int h, int kvh_n,
                                   int hd, int causal, int window,
                                   float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_f32<1>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd,
                         causal, window, scale, st);
  if (hd <= 64)
    return launch_f32<2>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd,
                         causal, window, scale, st);
  if (hd <= 128)
    return launch_f32<4>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd,
                         causal, window, scale, st);
  if (hd <= 256)
    return launch_f32<8>(q, k, v, out, lse, b, sq, sk, h, kvh_n, hd,
                         causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
