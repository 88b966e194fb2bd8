// Streaming-softmax attention over key tiles in f32 on the CUDA cores: the
// body of the f32 ring decode, paged decode and flash kernels (their bf16
// variants run attention_mma.cuh on the tensor cores), and the pieces both
// bodies share (the key policies, the decode row map, the split combine).
//
// A CTA owns up to kMaxRows query rows (each a head_dim vector) and walks a
// range of keys in tiles of kTileK. Where key j lives is a policy (the Keys
// template parameter of attend): a strided range for the ring and for
// flash, a block-table lookup for the paged pool. Per tile, lane i of the
// first warp asks the policy for key i's position and element offset; then
// K and V are staged in shared memory as float32, and each warp takes its
// rows one at a time: lane i scores key i (QK^T in f32), the warp reduces
// the tile max and sum with shuffles, and lane i accumulates head dims
// i, i+32, ... of P V. The running (m, l, acc) of every row lives in shared
// memory across tiles.
//
// Masking is explicit: a key is valid for a row iff its position is >= 0,
// not after the query (causal) and inside the window. A masked key gets
// p = 0 exactly (never exp(-1e30 - -1e30)), so a row with no valid key
// keeps l = 0 and is written as 0. A key no row of the CTA can see (empty
// slot, table hole, outside every row's band) is never read, and a tile
// with no such key is skipped after its positions are read.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int kTileK = 32;     // keys per tile: lane i scores key i
constexpr int kMaxRows = 64;   // query rows per CTA
constexpr float kNeg = -1e30f;

// an f32 result in the output's type
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Smem {
  long long* roff;   // rows: element offset of each row in q and out
  float* q;          // rows x hd
  float* acc;        // rows x hd, unnormalised P V
  float* k;          // kTileK x (hd + 1): odd pitch, lane-per-key reads
                     // fall on distinct banks
  float* v;          // kTileK x hd
  float* m;          // rows: running max
  float* l;          // rows: running sum of p
  int* qpos;         // rows: query position
  long long* koff;   // kTileK: element offset of each key's row in k and v
  int* kpos;         // kTileK: key positions of the current tile (-1 = none)
  int* bounds;       // [min, max] query position of the CTA's rows
};

__host__ __device__ inline size_t smem_bytes(int rows, int hd) {
  return sizeof(long long) * (rows + kTileK) +
         sizeof(float) * (2 * rows * hd + kTileK * (hd + 1) + kTileK * hd +
                          2 * rows) +
         sizeof(int) * (rows + kTileK + 2);
}

__device__ inline Smem carve(unsigned char* base, int rows, int hd) {
  Smem s;
  s.roff = reinterpret_cast<long long*>(base);
  s.koff = s.roff + rows;
  s.q = reinterpret_cast<float*>(s.koff + kTileK);
  s.acc = s.q + rows * hd;
  s.k = s.acc + rows * hd;
  s.v = s.k + kTileK * (hd + 1);
  s.m = s.v + kTileK * hd;
  s.l = s.m + rows;
  s.qpos = reinterpret_cast<int*>(s.l + rows);
  s.kpos = s.qpos + rows;
  s.bounds = s.kpos + kTileK;
  return s;
}

// The decode kernels fold the T x G query rows of a (slot b, KV head kvh)
// into one CTA: row i = token i / G, query head kvh * G + i % G. Rows
// [row0, row0 + nrows) get their element offset in q and out (roff) and,
// when q_pos is given, their position (qpos); either may be null.
__device__ __forceinline__ void decode_rows(long long* roff, int* qpos,
                                            const int* __restrict__ q_pos,
                                            int b, int kvh, int tq, int h,
                                            int g, int hd, int row0,
                                            int nrows) {
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int gr = row0 + r, t = gr / g, head = kvh * g + (gr - t * g);
    if (roff) roff[r] = ((static_cast<long long>(b) * tq + t) * h + head) * hd;
    if (qpos) qpos[r] = q_pos[static_cast<long long>(b) * tq + t];
  }
}

// After the caller filled roff/qpos for rows [0, nrows): stage q, reset the
// softmax state and record the query-position bounds.
__device__ inline void load_rows(const Smem& s, const float* __restrict__ q,
                                 int nrows,
                          int hd) {
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    s.q[e] = q[s.roff[r] + d];
    s.acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    s.m[r] = kNeg;
    s.l[r] = 0.f;
  }
  if (threadIdx.x == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < nrows; ++r) {
      lo = min(lo, s.qpos[r]);
      hi = max(hi, s.qpos[r]);
    }
    s.bounds[0] = lo;
    s.bounds[1] = hi;
  }
  __syncthreads();
}

// Copy the current tile's keys (row of key i at src + s.koff[i], 16-byte
// vectors) into a float tile with row pitch `pitch`; keys with position -1
// are not read and stay zero.
__device__ inline void load_tile(float* dst, int pitch,
                                 const float* __restrict__ src,
                                 const Smem& s, int hd) {
  const int nv = hd / 4;
  for (int e = threadIdx.x; e < kTileK * nv; e += blockDim.x) {
    const int key = e / nv, d0 = (e - key * nv) * 4;
    const float4 x = s.kpos[key] >= 0
        ? *reinterpret_cast<const float4*>(src + s.koff[key] + d0)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    float* o = dst + key * pitch + d0;
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

// Key addressing for a contiguous run of keys: key j's row is at
// base + j * stride, its position kpos[j] (-1 = empty), or j itself when
// kpos is null (flash: keys sit at positions 0..Sk-1).
struct StridedKeys {
  long long base, stride;
  const int* __restrict__ kpos;
  __device__ __forceinline__ int locate(int j, long long& off) const {
    off = base + j * stride;
    return kpos ? kpos[j] : j;
  }
};

// Key addressing through a block table: logical key j of a slot is token
// j % bs of pool block table[j / bs]; -1 in the table is a hole (no key,
// nothing read). Pool rows are (N, bs, KV, hd), positions (N, bs).
struct PagedKeys {
  const int* __restrict__ table;   // the slot's row of block ids
  const int* __restrict__ kpos;    // (N, bs)
  int bs;
  long long tok_stride, head_off;  // KV * hd, kv_head * hd
  __device__ __forceinline__ int locate(int j, long long& off) const {
    const int lb = j / bs;
    const int blk = table[lb];
    off = 0;
    if (blk < 0) return -1;
    const long long tok = static_cast<long long>(blk) * bs + (j - lb * bs);
    off = tok * tok_stride + head_off;
    return kpos[tok];
  }
};

__device__ __forceinline__ bool key_valid(int p, int qp, bool causal,
                                          int window) {
  return p >= 0 && (!causal || p <= qp) && (window <= 0 || p > qp - window);
}

// Walk keys [key_lo, key_hi); `keys` (StridedKeys, PagedKeys) says where
// each key's K/V row lives and what its position is. LD = head dims per
// lane (hd <= 32 * LD).
template <int LD, typename Keys>
__device__ void attend(const Smem& s, const float* __restrict__ k,
                       const float* __restrict__ v, const Keys& keys,
                       int key_lo, int key_hi, int nrows, int hd,
                       bool causal, int window, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int qmin = s.bounds[0], qmax = s.bounds[1];
  for (int k0 = key_lo; k0 < key_hi; k0 += kTileK) {
    const int nk = min(kTileK, key_hi - k0);
    const int tid = static_cast<int>(threadIdx.x);
    int live = 0;
    if (tid < kTileK) {
      int p = -1;
      long long off = 0;
      if (tid < nk) p = keys.locate(k0 + tid, off);
      // the rows' positions span [qmin, qmax]: a key outside every row's
      // band cannot be valid for any row, so it is dropped here and read
      // by no one
      live = p >= 0 && (!causal || p <= qmax) &&
             (window <= 0 || p > qmin - window);
      s.kpos[tid] = live ? p : -1;
      s.koff[tid] = off;
    }
    if (!__syncthreads_or(live)) continue;
    load_tile(s.k, hd + 1, k, s, hd);
    load_tile(s.v, hd, v, s, hd);
    __syncthreads();
    const int p = s.kpos[lane];
    for (int r = warp; r < nrows; r += nwarps) {
      const bool ok = key_valid(p, s.qpos[r], causal, window);
      float sc = kNeg;
      if (ok) {
        const float* qr = s.q + r * hd;
        const float* kr = s.k + lane * (hd + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
      }
      float mt = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, mt);
      const float pe = ok ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m_prev - m_new);
      float ps = pe;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      float* accr = s.acc + r * hd;
      float a[LD];
#pragma unroll
      for (int i = 0; i < LD; ++i) {
        const int d = lane + 32 * i;
        a[i] = d < hd ? accr[d] * alpha : 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pe, j);
        const float* vr = s.v + j * hd;
#pragma unroll
        for (int i = 0; i < LD; ++i) {
          const int d = lane + 32 * i;
          if (d < hd) a[i] = fmaf(pj, vr[d], a[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < LD; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) accr[d] = a[i];
      }
      __syncwarp();
      if (lane == 0) {
        s.m[r] = m_new;
        s.l[r] = s.l[r] * alpha + ps;
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

__device__ inline void store_rows(const Smem& s, float* __restrict__ out,
                                  int nrows,
                           int hd) {
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * hd; e += blockDim.x) {
    const int r = e / hd;
    const float l = s.l[r];
    out[s.roff[r] + (e - r * hd)] = l > 0.f ? s.acc[e] / l : 0.f;
  }
}

// Flash decoding: a CTA that walked one split of the key axis writes its
// rows' partial (max, sum, unnormalised P V) to f32 scratch laid out as
// m_part, l_part (rows, nsplit) and acc_part (rows, nsplit, hd), where the
// output row is roff / hd.
__device__ inline void store_split(const Smem& s, int nrows, int hd,
                                   int split, int nsplit,
                                   float* __restrict__ m_part,
                                   float* __restrict__ l_part,
                                   float* __restrict__ acc_part) {
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * hd; e += blockDim.x) {
    const int r = e / hd;
    const long long row = s.roff[r] / hd;
    acc_part[(row * nsplit + split) * hd + (e - r * hd)] = s.acc[e];
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const long long row = s.roff[r] / hd;
    m_part[row * nsplit + split] = s.m[r];
    l_part[row * nsplit + split] = s.l[r];
  }
}

// One CTA per output row: rescale each split by exp(m_split - max) and
// normalise. A split that saw no key has m = -1e30, l = 0, acc = 0.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               const float* __restrict__ acc_part,
                               T* __restrict__ out, int nsplit, int hd) {
  const long long row = blockIdx.x;
  const float* m = m_part + row * nsplit;
  const float* l = l_part + row * nsplit;
  float mx = kNeg;
  for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, m[i]);
  float sum = 0.f;
  for (int i = 0; i < nsplit; ++i) sum += l[i] * expf(m[i] - mx);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i)
      a += acc_part[(row * nsplit + i) * hd + d] * expf(m[i] - mx);
    store_out(out + row * hd + d, sum > 0.f ? a / sum : 0.f);
  }
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
