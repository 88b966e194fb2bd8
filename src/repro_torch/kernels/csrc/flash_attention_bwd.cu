// Full-sequence GQA flash attention backward (causal or windowed), for
// Hopper (sm_90a): dq, dk and dv of flash_attention.cu's forward, the
// training path's attention gradient.
//
// Replaces no TPU kernel: repro has no Pallas backward. Its gradient is the
// custom VJP of the jnp blockwise_attention (src/repro/models/attention.py,
// _flash_bwd and _banded_bwd), and this kernel computes that arithmetic:
// with the forward's out and its f32 log-sum-exp lse (natural-log units,
// flash_attention.cu writes it when asked),
//   D = rowsum(dout * out), P = exp(s * scale - lse) inside the band,
//   dv = P^T dout, dS = P * (dP - D) * scale with dP = dout v^T,
//   dq = dS k, dk = dS^T q,
// all in f32, stored in the input dtype. Queries are right-aligned to keys
// (query i sits at position i + Sk - Sq), query head h reads KV head h / G,
// a masked (query, key) pair gets P = dS = 0 exactly, and a row with no
// valid key (lse = -inf, out = 0) gets zero gradients and no NaN.
//
// Bound on this card: operations. The backward recomputes S and does four
// more products of the forward's size (dP, dv, dq, dk), 2.5x the forward's
// flops, on the same bytes: far above the ~295 flop/byte where the H100's
// bf16 tensor cores become the limit, in the band of every training shape.
//
// bf16 (head_dim a multiple of 8 up to 256, as the forward): the five
// products on the tensor cores, mma.sync.m16n8k16 with f32
// accumulation through attention_mma.cuh's fragments and ldmatrix
// addressing, as flash_attention.cu's forward. Two kernels, the same split
// as below: dq (a warp owns 16 query rows: S = Q K^T and dP = dO V^T in
// registers, dS on the fragments, rounded to bf16 as the A operand of
// dq += dS K, as the forward rounds P) and dk/dv (a warp owns 16 keys:
// S^T = K Q^T, dP^T = V dO^T, dv += P^T dO, dk += dS^T Q with dk and dv in
// registers across every query tile of the band). Tiles are staged by
// cp.async with a barrier a tile (no second stage yet); above 64 dims the
// warp's own operand is reloaded from shared memory each k-step and the
// tiles walked are 32 wide (16 above 128 dims), so dk and dv (128
// registers at 128 dims) fit; above 128 dims (MLA's 192, recurrentgemma's
// 256) two dk/dv CTAs share a key tile, each with half of the dims.
//
// f32: every product on the CUDA cores in f32 (mma.sync on f32 data is
// TF32, which the f32 checks would not pass). Two kernels here too, both
// deterministic (no atomics), launched in this order by one call:
// 1. dq: one CTA per (batch, 32-query tile, q head). It stages its rows of
//    q and dout, computes and writes D for them (the second kernel reads
//    it), then walks the key tiles of its band: S and dP for the tile's
//    (row, key) pairs (warp per row, lane per key, K and V at an odd pitch
//    so the lanes' reads fall on distinct banks), dS into shared memory,
//    dq += dS k with each thread owning fixed (row, dim) entries.
// 2. dk/dv: one CTA per (batch, KV head, 32-key tile). Its K and V tile and
//    its dk/dv accumulators stay in shared memory while it walks, for each
//    of the G query heads of its KV head, every query tile that can see one
//    of its keys; per tile P and dS are built as in (1) and dv += P^T dout,
//    dk += dS^T q are added by fixed (key, dim) owners, so the sums over the
//    G heads and the query tiles run in one fixed order.
// Shared memory is f32 throughout: at hd 256 the dk/dv CTA holds 205 KB
// (one CTA an SM), at hd 64 58 KB.
//
// Layouts (all contiguous, the bf16 ones 16-byte aligned): q, dq, out,
// dout (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd); lse, delta (B, Sq, H)
// f32 (delta is scratch the first kernel fills).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

// -- bf16: tensor cores -------------------------------------------------------

namespace tc {

using attn::mma::bf16;
using attn::mma::cp_async16;
using attn::mma::cp_async_commit;
using attn::mma::cp_async_wait;
using attn::mma::exp2_ftz;
using attn::mma::kLog2e;
using attn::mma::ldsm_x4;
using attn::mma::ldsm_x4_t;
using attn::mma::mma_bf16;
using attn::mma::pack_bf16;

constexpr int kRows = 64;       // query rows (dq) or keys (dk/dv) a CTA owns
constexpr int kWarps = 4;       // 16 of them a warp

// The compile-time shape of a head-dim class (hd <= HDMAX, 64, 128 or
// 256; head dims zero-padded to HDMAX in shared memory). kTile: the keys
// (dq) or query rows (dk/dv) walked a step; kInRegs: the warp's own operand
// (Q and dO for dq, K and V for dk/dv) kept as A fragments in registers,
// else reloaded from shared memory a k-step (at 128 dims the dk and dv
// accumulators take 128 registers); kSplit: the dk/dv CTAs that share a
// key tile, each accumulating HDMAX / kSplit of the head dims (at 256
// dims, dk and dv whole would take 256 registers; each CTA recomputes S^T
// and dP^T, 2 of the 5 products).
template <int HDMAX>
struct Shape {
  static constexpr int kPitch = HDMAX + 8;   // 16 bytes of padding a row
  static constexpr int kChunks = HDMAX / 8;  // 16-byte copies a row
  static constexpr int kSteps = HDMAX / 16;  // k-steps over head dims
  static constexpr int kTile = HDMAX <= 64 ? 64 : HDMAX <= 128 ? 32 : 16;
  static constexpr bool kInRegs = HDMAX <= 64;
  static constexpr int kSplit = HDMAX <= 128 ? 1 : 2;
};

// rows [0, rows) of a tile: row r at src + base + r * stride (rows past n
// and dims past hd zero-filled), by cp.async
template <int HDMAX>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                      long long base, long long stride,
                                      int n, int rows, int hd) {
  using S = Shape<HDMAX>;
  const int c = threadIdx.x % S::kChunks;
  const bool col = c * 8 < hd;
  for (int r = threadIdx.x / S::kChunks; r < rows;
       r += blockDim.x / S::kChunks) {
    const bool rd = r < n && col;
    cp_async16(dst + r * S::kPitch + c * 8,
               rd ? src + base + r * stride + c * 8 : src, rd);
  }
}

// ldmatrix row addresses (see attention_mma.cuh): an A operand (16 rows x
// 16 k) at `a`, a B operand from rows that are its n (keys of S = Q K^T) at
// `b`, a B operand from rows that are its k (V of P V) at `bt` (.trans)
__device__ __forceinline__ int a_off(int lane, int p) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * p + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int p) {
  return ((lane & 7) + (lane >> 4) * 8) * p + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int p) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * p + (lane >> 4) * 8;
}

// acc (m16 x N) += A (16 x 16 k-slices, register fragments) times the
// B operand of N columns from shared memory rows that are its n, NT n-tiles
// of 8; a[d] for k-step d
template <int KSTEPS, int NT>
__device__ __forceinline__ void mm_abn(float (&acc)[NT][4],
                                       const unsigned (&a)[KSTEPS][4],
                                       const bf16* b, int p) {
#pragma unroll
  for (int d = 0; d < KSTEPS; ++d)
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      unsigned f[4];
      ldsm_x4(f, b + n2 * 16 * p + d * 16);
      mma_bf16(acc[2 * n2], a[d], f[0], f[1]);
      mma_bf16(acc[2 * n2 + 1], a[d], f[2], f[3]);
    }
}

// acc (16 x HDMAX) += P (16 x K, C fragments rounded to bf16 as A) times
// the rows of `bt` (K rows: k, HDMAX columns: n) from shared memory
template <int HDMAX, int K>
__device__ __forceinline__ void mm_pbt(float (&acc)[HDMAX / 8][4],
                                       const float (&pc)[K / 8][4],
                                       const bf16* bt, int p) {
#pragma unroll
  for (int k2 = 0; k2 < K / 16; ++k2) {
    unsigned a[4];
    a[0] = pack_bf16(pc[2 * k2][0], pc[2 * k2][1]);
    a[1] = pack_bf16(pc[2 * k2][2], pc[2 * k2][3]);
    a[2] = pack_bf16(pc[2 * k2 + 1][0], pc[2 * k2 + 1][1]);
    a[3] = pack_bf16(pc[2 * k2 + 1][2], pc[2 * k2 + 1][3]);
#pragma unroll
    for (int n2 = 0; n2 < HDMAX / 16; ++n2) {
      unsigned f[4];
      ldsm_x4_t(f, bt + k2 * 16 * p + n2 * 16);
      mma_bf16(acc[2 * n2], a, f[0], f[1]);
      mma_bf16(acc[2 * n2 + 1], a, f[2], f[3]);
    }
  }
}

// write a warp's 16 x W accumulator rows (row r's dims d0 .. d0 + W - 1
// to dst + off[r] + d0, dims past hd dropped) as bf16
template <int W>
__device__ __forceinline__ void store_acc(const float (&acc)[W / 8][4],
                                          bf16* __restrict__ dst,
                                          const long long (&off)[2],
                                          const bool (&ok)[2], int d0,
                                          int hd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      const int d = d0 + n * 8 + (lane & 3) * 2;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + off[r] + d) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// One CTA per (batch, 64-query tile, q head); warp w owns rows 16 w ..
// 16 w + 15. D = rowsum(dout * out) first (written to delta for the dk/dv
// kernel), then per key tile of the band: S = Q K^T and dP = dO V^T on the
// tensor cores, dS = P (dP - D) scale on the fragments, dq += dS K.
template <int HDMAX>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ out,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq,
                        int sq, int sk, int h, int kvh_n, int hd, int causal,
                        int window, float scale) {
  using S = Shape<HDMAX>;
  constexpr int P = S::kPitch, KT = S::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);   // kRows x P
  bf16* s_do = s_q + kRows * P;                      // kRows x P
  bf16* s_k = s_do + kRows * P;                      // KT x P
  bf16* s_v = s_k + KT * P;                          // KT x P
  float* s_d = reinterpret_cast<float*>(s_v + KT * P);   // kRows
  float* s_l = s_d + kRows;                               // kRows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heavy tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int nr = min(kRows, sq - q0), shift = sk - sq;
  const int kvh = head / (h / kvh_n);
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const long long qbase = (static_cast<long long>(b) * sq + q0) * h * hd +
                          static_cast<long long>(head) * hd;
  const long long qstride = static_cast<long long>(h) * hd;
  const long long kstride = static_cast<long long>(kvh_n) * hd;
  const long long kbase = static_cast<long long>(b) * sk * kstride +
                          static_cast<long long>(kvh) * hd;
  stage<HDMAX>(s_q, q, qbase, qstride, nr, kRows, hd);
  stage<HDMAX>(s_do, dout, qbase, qstride, nr, kRows, hd);
  cp_async_commit();
  // D and lse (log2 units) of the warp's rows: lanes over dims
  for (int r = row0; r < row0 + 16; ++r) {
    float acc = 0.f;
    if (r < nr)
      for (int d = lane; d < hd; d += 32) {
        const long long i = qbase + r * qstride + d;
        acc = fmaf(__bfloat162float(dout[i]), __bfloat162float(out[i]), acc);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const long long row = (static_cast<long long>(b) * sq + q0 + r) * h +
                            head;
      s_d[r] = acc;
      s_l[r] = r < nr ? lse[row] * kLog2e : 0.f;
      if (r < nr) delta[row] = acc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  constexpr int NF = S::kInRegs ? S::kSteps : 1;
  unsigned qf[NF][4], of[NF][4];
  if constexpr (S::kInRegs) {
#pragma unroll
    for (int d = 0; d < S::kSteps; ++d) {
      ldsm_x4(qf[d], s_q + row0 * P + a_off(lane, P) + d * 16);
      ldsm_x4(of[d], s_do + row0 * P + a_off(lane, P) + d * 16);
    }
  }
  int qp[2];
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    qp[r] = row < nr ? q0 + row + shift : INT_MIN;   // a padding row
    l2[r] = s_l[row];
    dr[r] = s_d[row];
  }
  float acc[HDMAX / 8][4];
#pragma unroll
  for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = scale * kLog2e;
  const int first = q0 + shift, last = q0 + nr - 1 + shift;
  const int hi = causal ? min(sk, last + 1) : sk;
  const int lo = window > 0 ? max(0, first - window + 1) : 0;
  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();                        // the last tile is consumed
    const int nk = min(KT, hi - k0);
    stage<HDMAX>(s_k, k, kbase + k0 * kstride, kstride, nk, KT, hd);
    stage<HDMAX>(s_v, v, kbase + k0 * kstride, kstride, nk, KT, hd);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    if constexpr (S::kInRegs) {
      mm_abn<S::kSteps, KT / 8>(sc, qf, s_k + b_off(lane, P), P);
      mm_abn<S::kSteps, KT / 8>(dp, of, s_v + b_off(lane, P), P);
    } else {
#pragma unroll 2
      for (int d = 0; d < S::kSteps; ++d) {
        unsigned a[1][4];
        ldsm_x4(a[0], s_q + row0 * P + a_off(lane, P) + d * 16);
        mm_abn<1, KT / 8>(sc, a, s_k + b_off(lane, P) + d * 16, P);
        ldsm_x4(a[0], s_do + row0 * P + a_off(lane, P) + d * 16);
        mm_abn<1, KT / 8>(dp, a, s_v + b_off(lane, P) + d * 16, P);
      }
    }
    // dS = P (dP - D) scale, P = exp(s scale - lse) on valid pairs
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const int qpos = qp[e >> 1];
        const bool ok = key < hi && qpos != INT_MIN &&
                        (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
        const float p = ok ? exp2_ftz(fmaf(sc[n][e], scale2, -l2[e >> 1]))
                           : 0.f;
        sc[n][e] = p * (dp[n][e] - dr[e >> 1]) * scale;
      }
    mm_pbt<HDMAX, KT>(acc, sc, s_k + bt_off(lane, P), P);
  }
  long long off[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    ok[r] = row < nr;
    off[r] = qbase + row * qstride;
  }
  store_acc<HDMAX>(acc, dq, off, ok, 0, hd);
}

// One CTA per (batch, KV head, 64-key tile, dims split); warp w owns keys
// 16 w .. 16 w + 15, whose dk and dv (over the split's dims) stay in
// registers while the CTA walks, for each of the G query heads, every
// query tile that can see one of its keys: S^T = K Q^T and dP^T = V dO^T,
// then P^T and dS^T on the fragments, dv += P^T dO and dk += dS^T Q. The
// sums over heads and tiles run in one order.
template <int HDMAX>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int sq, int sk, int h, int kvh_n, int hd,
                          int causal, int window, float scale) {
  using S = Shape<HDMAX>;
  constexpr int P = S::kPitch, QT = S::kTile, OW = HDMAX / S::kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);   // kRows x P
  bf16* s_v = s_k + kRows * P;                       // kRows x P
  bf16* s_q = s_v + kRows * P;                       // QT x P
  bf16* s_do = s_q + QT * P;                         // QT x P
  float* s_l = reinterpret_cast<float*>(s_do + QT * P);  // QT
  float* s_d = s_l + QT;                                   // QT
  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y;
  const int b = blockIdx.z / S::kSplit;
  const int d0 = (blockIdx.z - b * S::kSplit) * OW;   // the split's dims
  const int nk = min(kRows, sk - k0), shift = sk - sq, g = h / kvh_n;
  const int lane = threadIdx.x & 31, key0 = (threadIdx.x >> 5) * 16;
  const long long kstride = static_cast<long long>(kvh_n) * hd;
  const long long kbase = (static_cast<long long>(b) * sk + k0) * kstride +
                          static_cast<long long>(kvh) * hd;
  const long long qstride = static_cast<long long>(h) * hd;
  stage<HDMAX>(s_k, k, kbase, kstride, nk, kRows, hd);
  stage<HDMAX>(s_v, v, kbase, kstride, nk, kRows, hd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  constexpr int NF = S::kInRegs ? S::kSteps : 1;
  unsigned kf[NF][4], vf[NF][4];
  if constexpr (S::kInRegs) {
#pragma unroll
    for (int d = 0; d < S::kSteps; ++d) {
      ldsm_x4(kf[d], s_k + key0 * P + a_off(lane, P) + d * 16);
      ldsm_x4(vf[d], s_v + key0 * P + a_off(lane, P) + d * 16);
    }
  }
  int kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + (lane >> 2) + 8 * r;
    kp[r] = key < nk ? k0 + key : INT_MAX;     // a padding key
  }
  float adk[OW / 8][4], adv[OW / 8][4];
#pragma unroll
  for (int n = 0; n < OW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float scale2 = scale * kLog2e;
  // the query rows that can see one of keys [k0, k0 + nk)
  const int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi = window > 0 ? min(sq, k0 + nk - 1 + window - shift) : sq;
  for (int head = kvh * g; head < (kvh + 1) * g; ++head) {
    for (int q0 = i_lo; q0 < i_hi; q0 += QT) {
      const int nr = min(QT, sq - q0);
      const long long qbase =
          (static_cast<long long>(b) * sq + q0) * qstride +
          static_cast<long long>(head) * hd;
      __syncthreads();                      // the last tile is consumed
      stage<HDMAX>(s_q, q, qbase, qstride, nr, QT, hd);
      stage<HDMAX>(s_do, dout, qbase, qstride, nr, QT, hd);
      cp_async_commit();
      for (int r = threadIdx.x; r < QT; r += blockDim.x) {
        const long long row = (static_cast<long long>(b) * sq + q0 + r) * h +
                              head;
        s_l[r] = r < nr ? lse[row] * kLog2e : 0.f;
        s_d[r] = r < nr ? delta[row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int n = 0; n < QT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      if constexpr (S::kInRegs) {
        mm_abn<S::kSteps, QT / 8>(st, kf, s_q + b_off(lane, P), P);
        mm_abn<S::kSteps, QT / 8>(dpt, vf, s_do + b_off(lane, P), P);
      } else {
#pragma unroll 2
        for (int d = 0; d < S::kSteps; ++d) {
          unsigned a[1][4];
          ldsm_x4(a[0], s_k + key0 * P + a_off(lane, P) + d * 16);
          mm_abn<1, QT / 8>(st, a, s_q + b_off(lane, P) + d * 16, P);
          ldsm_x4(a[0], s_v + key0 * P + a_off(lane, P) + d * 16);
          mm_abn<1, QT / 8>(dpt, a, s_do + b_off(lane, P) + d * 16, P);
        }
      }
      // P^T and dS^T: row = key kp[e >> 1], column = query c
#pragma unroll
      for (int n = 0; n < QT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + (lane & 3) * 2 + (e & 1);
          const int key = kp[e >> 1], qpos = q0 + c + shift;
          const bool ok = c < nr && key != INT_MAX &&
                          (!causal || key <= qpos) &&
                          (window <= 0 || key > qpos - window);
          const float p = ok ? exp2_ftz(fmaf(st[n][e], scale2, -s_l[c]))
                             : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - s_d[c]) * scale;
        }
      mm_pbt<OW, QT>(adv, st, s_do + bt_off(lane, P) + d0, P);
      mm_pbt<OW, QT>(adk, dpt, s_q + bt_off(lane, P) + d0, P);
    }
  }
  long long off[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ok[r] = kp[r] != INT_MAX;
    off[r] = kbase + (key0 + (lane >> 2) + 8 * r) * kstride;
  }
  store_acc<OW>(adk, dk, off, ok, d0, hd);
  store_acc<OW>(adv, dv, off, ok, d0, hd);
}

template <int HDMAX>
size_t dq_smem() {
  using S = Shape<HDMAX>;
  return sizeof(bf16) * (2 * kRows + 2 * S::kTile) * S::kPitch +
         sizeof(float) * 2 * kRows;
}

template <int HDMAX>
size_t dkdv_smem() {
  using S = Shape<HDMAX>;
  return sizeof(bf16) * (2 * kRows + 2 * S::kTile) * S::kPitch +
         sizeof(float) * 2 * S::kTile;
}

template <int HDMAX>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int b, int sq, int sk, int h, int kvh_n,
           int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  auto k1 = flash_bwd_dq_mma_kernel<HDMAX>;
  auto k2 = flash_bwd_dkdv_mma_kernel<HDMAX>;
  cudaError_t err = attn::allow_smem(k1, dq_smem<HDMAX>());
  if (err == cudaSuccess) err = attn::allow_smem(k2, dkdv_smem<HDMAX>());
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<dim3((sq + kRows - 1) / kRows, h, b), 32 * kWarps, dq_smem<HDMAX>(),
       stream>>>(q, k, v, out, dout, lse, delta, dq, sq, sk, h, kvh_n, hd,
                 causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3((sk + kRows - 1) / kRows, kvh_n, b * Shape<HDMAX>::kSplit),
       32 * kWarps, dkdv_smem<HDMAX>(), stream>>>(q, k, v, dout, lse, delta,
                                                dk, dv, sq, sk, h, kvh_n, hd,
                                                causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// -- f32: CUDA cores ----------------------------------------------------------

namespace {

constexpr int kTile = 32;      // query rows and keys per tile
constexpr int kThreads = 256;  // 8 warps

__device__ __forceinline__ bool visible(int kp, int qp, bool causal,
                                        int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Stage n rows (row r at src + row_off(r), hd values) as f32 at pitch
// `pitch`; rows n .. kTile - 1 are zero-filled, so a padding row or key
// adds 0 (never NaN) to every sum.
template <typename Off>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const float* __restrict__ src,
                                      Off row_off, int n, int hd) {
  for (int e = threadIdx.x; e < kTile * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    dst[r * pitch + d] = r < n ? src[row_off(r) + d] : 0.f;
  }
}

// P (when p_out is not null) and dS of the tile's (row, key) pairs: warp w
// takes rows w, w + 8, ..; lane j key j. q, dout at pitch hd; k, v at
// pitch hd + 1. Row r sits at position q_pos0 + r, key j at k_pos0 + j.
__device__ __forceinline__ void scores(const float* sq, const float* sdo,
                                       const float* sk, const float* sv,
                                       const float* slse, const float* sd,
                                       float* p_out, float* ds_out, int nr,
                                       int nk, int q_pos0, int k_pos0,
                                       int hd, bool causal, int window,
                                       float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* kr = sk + lane * (hd + 1);
  const float* vr = sv + lane * (hd + 1);
  for (int r = warp; r < kTile; r += nwarps) {
    float p = 0.f, ds = 0.f;
    if (r < nr && lane < nk &&
        visible(k_pos0 + lane, q_pos0 + r, causal, window)) {
      const float* qr = sq + r * hd;
      const float* dor = sdo + r * hd;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dor[d], vr[d], dp);
      }
      p = expf(s * scale - slse[r]);
      ds = p * (dp - sd[r]) * scale;
    }
    if (p_out) p_out[r * (kTile + 1) + lane] = p;
    ds_out[r * (kTile + 1) + lane] = ds;
  }
}

// -- dq (and D) ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int sq, int sk, int h, int kvh_n,
                    int hd, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                              // kTile x hd
  float* s_do = s_q + kTile * hd;                 // kTile x hd
  float* s_dq = s_do + kTile * hd;                // kTile x hd
  float* s_k = s_dq + kTile * hd;                 // kTile x (hd + 1)
  float* s_v = s_k + kTile * (hd + 1);            // kTile x (hd + 1)
  float* s_ds = s_v + kTile * (hd + 1);           // kTile x (kTile + 1)
  float* s_lse = s_ds + kTile * (kTile + 1);      // kTile
  float* s_d = s_lse + kTile;                     // kTile
  const int q0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int nr = min(kTile, sq - q0);
  const int shift = sk - sq;
  const int kvh = head / (h / kvh_n);
  auto q_off = [=](int r) {
    return ((static_cast<long long>(b) * sq + q0 + r) * h + head) * hd;
  };
  auto k_off = [=](long long j) {
    return ((static_cast<long long>(b) * sk + j) * kvh_n + kvh) * hd;
  };
  stage(s_q, hd, q, q_off, nr, hd);
  stage(s_do, hd, dout, q_off, nr, hd);
  for (int e = threadIdx.x; e < kTile * hd; e += blockDim.x) s_dq[e] = 0.f;
  // D = rowsum(dout * out): warp per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kTile; r += blockDim.x >> 5) {
    float acc = 0.f;
    if (r < nr)
      for (int d = lane; d < hd; d += 32)
        acc = fmaf(dout[q_off(r) + d], out[q_off(r) + d], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const long long row = (static_cast<long long>(b) * sq + q0 + r) * h +
                            head;
      s_d[r] = acc;
      s_lse[r] = r < nr ? lse[row] : 0.f;
      if (r < nr) delta[row] = acc;
    }
  }
  // the band of keys the tile's rows can see
  const int first = q0 + shift, last = q0 + nr - 1 + shift;
  const int hi = causal ? min(sk, last + 1) : sk;
  const int lo = window > 0 ? max(0, first - window + 1) : 0;
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    const int nk = min(kTile, hi - k0);
    __syncthreads();                  // the last tile's dS is consumed
    stage(s_k, hd + 1, k, [=](int j) { return k_off(k0 + j); }, nk, hd);
    stage(s_v, hd + 1, v, [=](int j) { return k_off(k0 + j); }, nk, hd);
    __syncthreads();
    scores(s_q, s_do, s_k, s_v, s_lse, s_d, nullptr, s_ds, nr, nk, first,
           k0, hd, causal != 0, window, scale);
    __syncthreads();
    // dq[r][d] += sum_j dS[r][j] k[j][d]
    for (int e = threadIdx.x; e < kTile * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const float* dsr = s_ds + r * (kTile + 1);
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j)
        acc = fmaf(dsr[j], s_k[j * (hd + 1) + d], acc);
      s_dq[e] += acc;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    dq[q_off(r) + d] = s_dq[e];
  }
}

// -- dk, dv -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int sq, int sk, int h, int kvh_n,
                      int hd, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                              // kTile x (hd + 1)
  float* s_v = s_k + kTile * (hd + 1);            // kTile x (hd + 1)
  float* s_dk = s_v + kTile * (hd + 1);           // kTile x hd
  float* s_dv = s_dk + kTile * hd;                // kTile x hd
  float* s_q = s_dv + kTile * hd;                 // kTile x hd
  float* s_do = s_q + kTile * hd;                 // kTile x hd
  float* s_p = s_do + kTile * hd;                 // kTile x (kTile + 1)
  float* s_ds = s_p + kTile * (kTile + 1);        // kTile x (kTile + 1)
  float* s_lse = s_ds + kTile * (kTile + 1);      // kTile
  float* s_d = s_lse + kTile;                     // kTile
  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int nk = min(kTile, sk - k0);
  const int shift = sk - sq;
  const int g = h / kvh_n;
  auto k_off = [=](int j) {
    return ((static_cast<long long>(b) * sk + k0 + j) * kvh_n + kvh) * hd;
  };
  stage(s_k, hd + 1, k, k_off, nk, hd);
  stage(s_v, hd + 1, v, k_off, nk, hd);
  for (int e = threadIdx.x; e < kTile * hd; e += blockDim.x) {
    s_dk[e] = 0.f;
    s_dv[e] = 0.f;
  }
  // the query rows that can see one of keys [k0, k0 + nk): causal, a row
  // at position >= k0; windowed, one at position < k0 + nk - 1 + window
  const int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi = window > 0 ? min(sq, k0 + nk - 1 + window - shift) : sq;
  for (int head = kvh * g; head < (kvh + 1) * g; ++head) {
    for (int q0 = i_lo; q0 < i_hi; q0 += kTile) {
      const int nr = min(kTile, sq - q0);
      auto q_off = [=](int r) {
        return ((static_cast<long long>(b) * sq + q0 + r) * h + head) * hd;
      };
      __syncthreads();                // the last tile's P and dS are used
      stage(s_q, hd, q, q_off, nr, hd);
      stage(s_do, hd, dout, q_off, nr, hd);
      for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
        const long long row = (static_cast<long long>(b) * sq + q0 + r) * h +
                              head;
        s_lse[r] = r < nr ? lse[row] : 0.f;
        s_d[r] = r < nr ? delta[row] : 0.f;
      }
      __syncthreads();
      scores(s_q, s_do, s_k, s_v, s_lse, s_d, s_p, s_ds, nr, nk,
             q0 + shift, k0, hd, causal != 0, window, scale);
      __syncthreads();
      // dv[j][d] += sum_r P[r][j] dout[r][d]; dk[j][d] += sum_r dS[r][j]
      // q[r][d]
      for (int e = threadIdx.x; e < kTile * hd; e += blockDim.x) {
        const int j = e / hd, d = e - j * hd;
        float av = 0.f, ak = 0.f;
#pragma unroll 8
        for (int r = 0; r < kTile; ++r) {
          av = fmaf(s_p[r * (kTile + 1) + j], s_do[r * hd + d], av);
          ak = fmaf(s_ds[r * (kTile + 1) + j], s_q[r * hd + d], ak);
        }
        s_dv[e] += av;
        s_dk[e] += ak;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nk * hd; e += blockDim.x) {
    const int j = e / hd, d = e - j * hd;
    dk[k_off(j) + d] = s_dk[e];
    dv[k_off(j) + d] = s_dv[e];
  }
}

inline size_t dq_smem(int hd) {
  return sizeof(float) * (3 * kTile * hd + 2 * kTile * (hd + 1) +
                          kTile * (kTile + 1) + 2 * kTile);
}

inline size_t dkdv_smem(int hd) {
  return sizeof(float) * (2 * kTile * (hd + 1) + 4 * kTile * hd +
                          2 * kTile * (kTile + 1) + 2 * kTile);
}

int launch_f32(const float* q, const float* k, const float* v,
               const float* out, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int b, int sq,
               int sk, int h, int kvh_n, int hd, int causal, int window,
               float scale, cudaStream_t stream) {
  cudaError_t err = attn::allow_smem(flash_bwd_dq_kernel, dq_smem(hd));
  if (err == cudaSuccess)
    err = attn::allow_smem(flash_bwd_dkdv_kernel, dkdv_smem(hd));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3((sq + kTile - 1) / kTile, h, b), kThreads,
                        dq_smem(hd), stream>>>(
      q, k, v, out, dout, lse, delta, dq, sq, sk, h, kvh_n, hd, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<<<dim3((sk + kTile - 1) / kTile, kvh_n, b), kThreads,
                          dkdv_smem(hd), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, h, kvh_n, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: no sliding window; hd a multiple of 8 in [8, 256] (bf16,
// the tensor-core kernels) or in [1, 256] (f32). delta: (B, Sq, H) f32
// scratch. Returns a cudaError_t (0 = both kernels launched).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int h, int kvh_n, int hd, int causal,
    int window, float scale, void* stream) {
  using B = __nv_bfloat16;
  if (b < 1 || sq < 1 || sk < 1 || kvh_n < 1 || h % kvh_n || hd < 8 ||
      hd > 256 || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = hd <= 64 ? tc::launch<64>
                     : hd <= 128 ? tc::launch<128> : tc::launch<256>;
  return fn(static_cast<const B*>(q), static_cast<const B*>(k),
            static_cast<const B*>(v), static_cast<const B*>(out),
            static_cast<const B*>(dout), lse, delta, static_cast<B*>(dq),
            static_cast<B*>(dk), static_cast<B*>(dv), b, sq, sk, h, kvh_n,
            hd, causal, window, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int sq, int sk, int h, int kvh_n, int hd, int causal,
    int window, float scale, void* stream) {
  using F = float;
  if (b < 1 || sq < 1 || sk < 1 || kvh_n < 1 || h % kvh_n || hd < 1 ||
      hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(static_cast<const F*>(q), static_cast<const F*>(k),
                    static_cast<const F*>(v), static_cast<const F*>(out),
                    static_cast<const F*>(dout), lse, delta,
                    static_cast<F*>(dq), static_cast<F*>(dk),
                    static_cast<F*>(dv), b, sq, sk, h, kvh_n, hd, causal,
                    window, scale, static_cast<cudaStream_t>(stream));
}
