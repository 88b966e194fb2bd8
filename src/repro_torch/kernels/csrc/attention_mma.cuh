// Streaming-softmax attention on the bf16 tensor cores: the tile body of
// the bf16 ring decode (decode_attention.cu), paged decode
// (paged_decode_attention.cu) and flash (flash_attention.cu) kernels, which
// replace src/repro/kernels/decode_attention.py, decode_attention and
// paged_decode_attention, and src/repro/kernels/flash_attention.py,
// flash_attention.
//
// What bounded them before: the scalar body attn::attend
// (attention_tile.cuh), one warp per query row scoring one key per lane and
// accumulating P V by shuffles in f32 on the CUDA cores, reached 1.8-5.2
// TFLOP/s of the card's 989 in flash and kept the ring decode 25x above its
// byte bound. This body puts both products on the tensor cores and keeps
// the K/V copies in flight:
// - A warp owns 16 query rows. S = Q K^T and O += P V run on
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), fed from shared memory by
//   ldmatrix (.trans for V), each fragment loaded one step ahead of the
//   products that use it. Q's fragments stay in registers up to 128 dims;
//   at 256 they are reloaded per 16-dim step, so that O (16 x hd f32, hd / 2
//   registers a thread) fits without spilling.
// - The online softmax (m, l) lives on the accumulator fragments: each
//   thread holds two rows, reduced across its quad by shuffles. Scores are
//   kept in log2 units (scale * log2 e folded in), so p = 2^(s - m).
// - P is rounded to bf16 as the A operand of P V (the m16n8 C fragment of
//   S is the m16n8k16 A fragment of P, so P never leaves registers), as the
//   TPU kernel and the scalar body round it; l sums the unrounded p. O
//   stays f32 in registers and is normalised once at the end.
// - K and V are staged as bf16, never widened, by cp.async (16 bytes a
//   thread), double-buffered with one barrier a stage: stage i + 1 is in
//   flight while stage i is computed. A stage holds one warp tile of keys
//   per key group: the CTA's warps are row tiles x groups, each group
//   taking its own tile of every stage, and the groups' (m, l, O) are
//   merged in shared memory at the end, so that a CTA with few query rows
//   (a decode step, a short prompt) still keeps four warps on its keys.
// - Rows are padded by 16 bytes, so the eight row addresses of every
//   ldmatrix fall on distinct banks. head_dim is zero-padded to its class
//   (32, 64, 128, 256) by cp.async zero-fill, so any multiple of 8 in
//   [8, 256] works and every loop has a compile-time trip count.
// - Masking as in attn::key_valid: a masked key gets p = 0 exactly (a
//   select, never exp(-1e30 + 1e30)), so a row with no valid key keeps
//   l = 0 and is written as 0. A key no row of the CTA may see is not read
//   (its cp.async zero-fills), a tile with no such key is never loaded
//   (flash walks only the band; the ring lists its live tiles first), a
//   warp none of whose rows sees a tile skips it, and a tile every row sees
//   whole skips the per-key mask.
// - Where key j lives is a policy, as in the scalar body: attn::StridedKeys
//   (flash), or StagedKeys below, whose positions and offsets a decode CTA
//   stages once per split through attn::StridedKeys (the ring) or
//   attn::PagedKeys (the block pool); decode_cta is that CTA.
//
// f32 keeps the scalar body: mma.sync on f32 data is TF32 (~3 decimal
// digits), which the port's f32 checks (1e-4 against the plain versions,
// the 4-layer f32 model against the CPU at 2e-3) would not pass.
#pragma once

#include <climits>

#include "attention_tile.cuh"

namespace attn {
namespace mma {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The compile-time shape of a head-dim class (hd <= HDMAX; HDMAX is 32, 64,
// 128 or 256). head_dim is zero-padded to HDMAX in shared memory, so every
// loop below has a compile-time trip count. A warp's key tile (KW keys, a
// multiple of 16) is the kernels' other template parameter.
template <int HDMAX>
struct Shape {
  // bf16 per staged row: 16 bytes of padding put the eight rows of an
  // ldmatrix 4 banks apart
  static constexpr int kPitch = HDMAX + 8;
  static constexpr int kChunks = HDMAX / 8;    // 16-byte copies per row
  static constexpr int kSteps = HDMAX / 16;    // k-steps of Q K^T
  // Q's A fragments stay in registers up to 128 dims (32 registers); at
  // 256 they are reloaded from shared memory per k-step
  static constexpr bool kQInRegs = HDMAX <= 128;
};

// A stage holds `groups` warp tiles of kw keys (stage keys = groups * kw).
struct Smem {
  bf16* q;           // rows x pitch
  bf16* kv;          // 2 stages x (K, V), stage keys x pitch each
  int* kpos;         // 2 stages x stage keys: positions (-1 = not read)
  long long* roff;   // rows: element offset of each row in q and out
  long long* soff;   // staged keys (the ring): element offset of each key
  int* qpos;         // rows: query position
  int* spos;         // staged keys: position, -1 where no row may see it
  int* tiles;        // staged keys: first key of each live tile
  int* misc;         // [0]: the count of live tiles
};

// st: stage keys; max_keys: the keys stage_positions may stage (0 when the
// caller stages none), in warp tiles of kw
__host__ __device__ inline size_t smem_bytes(int rows, int pitch, int st,
                                             int kw, int max_keys) {
  return sizeof(bf16) * static_cast<size_t>(rows + 4 * st) * pitch +
         sizeof(int) * 2 * st + sizeof(long long) * (rows + max_keys) +
         sizeof(int) * (rows + max_keys + max_keys / kw + 1);
}

__device__ inline Smem carve(unsigned char* base, int rows, int pitch, int st,
                             int kw, int max_keys) {
  Smem s;
  s.q = reinterpret_cast<bf16*>(base);
  s.kv = s.q + rows * pitch;
  s.kpos = reinterpret_cast<int*>(s.kv + 4 * st * pitch);
  s.roff = reinterpret_cast<long long*>(s.kpos + 2 * st);
  s.soff = s.roff + rows;
  s.qpos = reinterpret_cast<int*>(s.soff + max_keys);
  s.spos = s.qpos + rows;
  s.tiles = s.spos + max_keys;
  s.misc = s.tiles + max_keys / kw;
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; read = false writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op; subnormal results flush to 0 (p < 2^-126 of the
// row's max, far below bf16's resolution of P)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

// a key some row with position in [qmin, qmax] may see
__device__ __forceinline__ bool key_live(int p, int qmin, int qmax,
                                         bool causal, int window) {
  return p >= 0 && (!causal || p <= qmax) &&
         (window <= 0 || p > qmin - window);
}

// One warp's running state: rows lane / 4 and lane / 4 + 8 of its 16, each
// thread holding dims 8 n + 2 (lane % 4) + {0, 1} of O for every n; m in
// log2 units.
template <int HDMAX>
struct Acc {
  float o[HDMAX / 8][4];
  float m[2], l[2];
};

template <int HDMAX>
using QFrags = unsigned[Shape<HDMAX>::kQInRegs ? HDMAX / 16 : 1][4];

// Where a CTA's warps stand: blockDim / 32 = row tiles x groups; warp w owns
// rows 16 (w % row tiles) .. + 15 and the w / row tiles-th warp tile of
// every stage.
struct Role {
  int row_tiles, group, row0;
  __device__ explicit Role(int groups) {
    const int warp = threadIdx.x >> 5;
    row_tiles = (blockDim.x >> 5) / groups;
    group = warp / row_tiles;
    row0 = (warp - group * row_tiles) * 16;
  }
};

// Stage `i`'s keys into buffer `buf`: warp tiles i * groups .. + groups - 1
// (tile t starts at tiles[t], or key_lo + t * KW when tiles is null; one
// past ntiles is empty), keys at or past key_hi not read. Thread t copies
// 16-byte column t % kChunks of every (blockDim / kChunks)-th key; live keys
// are read, the rest and the head_dim padding zero-filled.
template <int HDMAX, int KW, typename Keys>
__device__ __forceinline__ void load_stage(
    const Smem& s, int buf, int i, int groups, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const Keys& keys, const int* tiles,
    int ntiles, int key_lo, int key_hi, int hd, int qmin, int qmax,
    bool causal, int window) {
  using S = Shape<HDMAX>;
  const int st = groups * KW;
  bf16* sk = s.kv + buf * (2 * st * S::kPitch);
  bf16* sv = sk + st * S::kPitch;
  int* kp = s.kpos + buf * st;
  const int c = threadIdx.x % S::kChunks;
  const bool col = c * 8 < hd;
  const int step = blockDim.x / S::kChunks;
#pragma unroll 4
  for (int key = threadIdx.x / S::kChunks; key < st; key += step) {
    const int t = i * groups + key / KW;
    const int j =
        t < ntiles ? (tiles ? tiles[t] : key_lo + t * KW) + key % KW : key_hi;
    long long off = 0;
    int p = -1;
    if (j < key_hi) p = keys.locate(j, off);
    const bool live = key_live(p, qmin, qmax, causal, window);
    const bool rd = live && col;
    const long long go = rd ? off + c * 8 : 0;
    cp_async16(sk + key * S::kPitch + c * 8, k + go, rd);
    cp_async16(sv + key * S::kPitch + c * 8, v + go, rd);
    if (c == 0) kp[key] = live ? p : -1;
  }
}

// How the warp's rows (positions in [wqmin, wqmax]) see a staged tile:
// 0 no (row, key) pair is valid, 2 every pair is, 1 some are.
template <int KT>
__device__ __forceinline__ int tile_class(const int* kp, int wqmin, int wqmax,
                                          bool causal, int window) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = -1, hole = 0;
#pragma unroll
  for (int i = lane; i < KT; i += 32) {
    const int p = kp[i];
    hole |= p < 0;
    if (p >= 0) lo = min(lo, p);
    hi = max(hi, p);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  hole = __any_sync(0xffffffffu, hole);
  if (hi < 0 || (causal && lo > wqmax) ||
      (window > 0 && hi <= wqmin - window))
    return 0;
  const bool full = !hole && (!causal || hi <= wqmin) &&
                    (window <= 0 || lo > wqmax - window);
  return full ? 2 : 1;
}

// The online softmax of one tile's scores (raw Q K^T) on the fragments:
// masked entries (kMasked and bit 4 n + e of `valid` clear) get p = 0
// exactly. Leaves p in sc; returns the rescale factor of each row.
template <int KT, bool kMasked>
__device__ __forceinline__ void online_softmax(float (&sc)[KT / 8][4],
                                               unsigned valid, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               float scale2) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!kMasked || ((valid >> (n * 4 + e)) & 1u))
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mn[r] = fmaxf(m[r], mx[r] == kNeg ? kNeg : mx[r] * scale2);
    alpha[r] = exp2_ftz(m[r] - mn[r]);
    m[r] = mn[r];
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(sc[n][e], scale2, -mn[e >> 1]));
      if (kMasked && !((valid >> (n * 4 + e)) & 1u)) p = 0.f;
      sc[n][e] = p;
      ls[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
}

// One warp, its tile of a staged stage: classify, S = Q K^T, online
// softmax, O += P V. Fragments are loaded one step ahead of the products
// that use them.
template <int HDMAX, int KW>
__device__ __forceinline__ void tile_step(const Smem& s, int buf, int st,
                                          const Role& role, Acc<HDMAX>& a,
                                          const QFrags<HDMAX>& qf,
                                          const int (&qp)[2], int wqmin,
                                          int wqmax, bool causal, int window,
                                          float scale2) {
  using S = Shape<HDMAX>;
  constexpr int KT = KW, P = S::kPitch, N2 = KT / 16;
  constexpr int NV = HDMAX / 16, NPV = N2 * NV;
  const int lane = threadIdx.x & 31, row0 = role.row0;
  const bf16* sk = s.kv + buf * (2 * st * P) + role.group * KT * P;
  const bf16* sv = sk + st * P;
  const int* kp = s.kpos + buf * st + role.group * KT;
  const int cls = tile_class<KT>(kp, wqmin, wqmax, causal, window);
  if (cls == 0) return;
  // mask bit 4 n + e: key 8 n + 2 (lane % 4) + (e & 1), row e >> 1
  unsigned valid = 0;
  if (cls == 1) {
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = kp[n * 8 + (lane & 3) * 2 + (e & 1)];
        if (key_valid(p, qp[e >> 1], causal, window))
          valid |= 1u << (n * 4 + e);
      }
  }

  // S = Q K^T. ldmatrix row addresses: Q x4 = (rows 0-7 | 8-15) x (dims
  // 0-7 | 8-15); K x4 = (keys 0-7, dims 0-7 | 8-15), (keys 8-15, ...)
  float sc[KT / 8][4];
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  const bf16* qb = s.q + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                   (lane >> 4) * 8;
  const bf16* kb =
      sk + ((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 8;
  unsigned kf[2][N2][4], qs[2][4];
#pragma unroll
  for (int n2 = 0; n2 < N2; ++n2) ldsm_x4(kf[0][n2], kb + n2 * 16 * P);
  if constexpr (!S::kQInRegs) ldsm_x4(qs[0], qb);
#pragma unroll
  for (int d = 0; d < S::kSteps; ++d) {
    if (d + 1 < S::kSteps) {
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2)
        ldsm_x4(kf[(d + 1) & 1][n2], kb + n2 * 16 * P + (d + 1) * 16);
      if constexpr (!S::kQInRegs) ldsm_x4(qs[(d + 1) & 1], qb + (d + 1) * 16);
    }
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) {
      if constexpr (S::kQInRegs) {
        mma_bf16(sc[2 * n2], qf[d], kf[d & 1][n2][0], kf[d & 1][n2][1]);
        mma_bf16(sc[2 * n2 + 1], qf[d], kf[d & 1][n2][2], kf[d & 1][n2][3]);
      } else {
        mma_bf16(sc[2 * n2], qs[d & 1], kf[d & 1][n2][0], kf[d & 1][n2][1]);
        mma_bf16(sc[2 * n2 + 1], qs[d & 1], kf[d & 1][n2][2],
                 kf[d & 1][n2][3]);
      }
    }
  }

  float alpha[2];
  if (cls == 1)
    online_softmax<KT, true>(sc, valid, a.m, a.l, alpha, scale2);
  else
    online_softmax<KT, false>(sc, valid, a.m, a.l, alpha, scale2);
  // P (rounded to bf16) as the A operand: keys 16 k2 .. 16 k2 + 15
  unsigned pa[N2][4];
#pragma unroll
  for (int k2 = 0; k2 < N2; ++k2) {
    pa[k2][0] = pack_bf16(sc[2 * k2][0], sc[2 * k2][1]);
    pa[k2][1] = pack_bf16(sc[2 * k2][2], sc[2 * k2][3]);
    pa[k2][2] = pack_bf16(sc[2 * k2 + 1][0], sc[2 * k2 + 1][1]);
    pa[k2][3] = pack_bf16(sc[2 * k2 + 1][2], sc[2 * k2 + 1][3]);
  }
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < HDMAX / 8; ++n) {
      a.o[n][0] *= alpha[0];
      a.o[n][1] *= alpha[0];
      a.o[n][2] *= alpha[1];
      a.o[n][3] *= alpha[1];
    }
  }
  // O += P V. V x4.trans = (keys 0-7 | 8-15) x (dims 0-7 | 8-15): the B
  // fragments of two 8-dim n-tiles
  const bf16* vb =
      sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
  unsigned vf[2][4];
  ldsm_x4_t(vf[0], vb);
#pragma unroll
  for (int i = 0; i < NPV; ++i) {
    const int k2 = i / NV, n2 = i % NV;
    if (i + 1 < NPV)
      ldsm_x4_t(vf[(i + 1) & 1],
                vb + ((i + 1) / NV) * 16 * P + ((i + 1) % NV) * 16);
    mma_bf16(a.o[2 * n2], pa[k2], vf[i & 1][0], vf[i & 1][1]);
    mma_bf16(a.o[2 * n2 + 1], pa[k2], vf[i & 1][2], vf[i & 1][3]);
  }
}

// Stage the CTA's query rows (row r at q + s.roff[r]; rows past nrows and
// dims past hd zero-filled) as one cp.async group. After s.roff is set.
template <int HDMAX>
__device__ __forceinline__ void load_q(const Smem& s,
                                       const bf16* __restrict__ q, int nrows,
                                       int qrows, int hd) {
  using S = Shape<HDMAX>;
  const int c = threadIdx.x % S::kChunks;
  const bool col = c * 8 < hd;
  for (int r = threadIdx.x / S::kChunks; r < qrows;
       r += blockDim.x / S::kChunks) {
    const bool rd = r < nrows && col;
    cp_async16(s.q + r * S::kPitch + c * 8,
               rd ? q + s.roff[r] + c * 8 : q, rd);
  }
  cp_async_commit();
}

// Walk `ntiles` warp tiles of KW keys, `groups` of them at a time (one per
// warp group of the CTA, see Role): tile t starts at tiles[t], or at key_lo
// + t * KW when tiles is null; keys at or past key_hi are not read. The
// caller has filled s.qpos for rows [0, nrows), whose positions [qmin,
// qmax] bound, issued load_q and synchronised the CTA since. All threads
// stage; at the end the groups' states are merged into group 0's warps,
// which hold the result.
template <int HDMAX, int KW, typename Keys>
__device__ __forceinline__ void attend(const Smem& s,
                                       const bf16* __restrict__ q,
                                       const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       const Keys& keys, int nrows, int hd,
                                       int key_lo, int key_hi,
                                       const int* tiles, int ntiles,
                                       int groups, int qmin, int qmax,
                                       bool causal, int window, float scale,
                                       Acc<HDMAX>& a) {
  using S = Shape<HDMAX>;
  constexpr int P = S::kPitch;
  const Role role(groups);
  const int lane = threadIdx.x & 31, row0 = role.row0;
  const int st = groups * KW;
  const int nstages = (ntiles + groups - 1) / groups;
  if (nstages > 0)
    load_stage<HDMAX, KW>(s, 0, 0, groups, k, v, keys, tiles, ntiles, key_lo,
                          key_hi, hd, qmin, qmax, causal, window);
  cp_async_commit();                              // stage 0
#pragma unroll
  for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a.o[n][e] = 0.f;
  int qp[2], lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a.m[r] = kNeg;
    a.l[r] = 0.f;
    const int row = row0 + (lane >> 2) + 8 * r;
    qp[r] = row < nrows ? s.qpos[row] : -1;       // a padding row: not stored
    if (row < nrows) {
      lo = min(lo, qp[r]);
      hi = max(hi, qp[r]);
    }
  }
  const bool busy = row0 < nrows;                 // the warp has rows
  const int wqmin = __reduce_min_sync(0xffffffffu, lo);
  const int wqmax = __reduce_max_sync(0xffffffffu, hi);
  const float scale2 = scale * kLog2e;
  QFrags<HDMAX> qf;
  if constexpr (S::kQInRegs) {
    cp_async_wait<1>();                           // Q has landed
    __syncthreads();
    if (busy) {
      const bf16* qb = s.q + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                       (lane >> 4) * 8;
#pragma unroll
      for (int d = 0; d < S::kSteps; ++d) ldsm_x4(qf[d], qb + d * 16);
    }
  }
  // one barrier a stage: after it stage i has landed for every thread and
  // every warp is done with stage i - 1, whose buffer then takes i + 1
  for (int i = 0; i < nstages; ++i) {
    const int buf = i & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < nstages)
      load_stage<HDMAX, KW>(s, buf ^ 1, i + 1, groups, k, v, keys, tiles,
                            ntiles, key_lo, key_hi, hd, qmin, qmax, causal,
                            window);
    cp_async_commit();
    if (busy)
      tile_step<HDMAX, KW>(s, buf, st, role, a, qf, qp, wqmin, wqmax, causal,
                           window, scale2);
  }
  cp_async_wait<0>();
  if (groups > 1) {
    __syncthreads();                              // the stage buffers are idle
    // groups 1.. hand (o, m, l) to group 0 through the idle stage buffers,
    // lane-major so that no two lanes share a bank
    constexpr int NF = HDMAX / 2 + 4;
    float* xs = reinterpret_cast<float*>(s.kv) +
                (role.row0 / 16) * NF * 32 + lane;
    const int stride = role.row_tiles * NF * 32;
    if (busy && role.group > 0) {
      float* x = xs + (role.group - 1) * stride;
#pragma unroll
      for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(n * 4 + e) * 32] = a.o[n][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[(HDMAX / 2 + r) * 32] = a.m[r];
        x[(HDMAX / 2 + 2 + r) * 32] = a.l[r];
      }
    }
    __syncthreads();
    if (busy && role.group == 0) {
      for (int g = 1; g < groups; ++g) {
        const float* x = xs + (g - 1) * stride;
        float fa[2], fx[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = x[(HDMAX / 2 + r) * 32];
          const float mn = fmaxf(a.m[r], mx);
          fa[r] = exp2_ftz(a.m[r] - mn);
          fx[r] = exp2_ftz(mx - mn);
          a.m[r] = mn;
          a.l[r] = a.l[r] * fa[r] + x[(HDMAX / 2 + 2 + r) * 32] * fx[r];
        }
#pragma unroll
        for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a.o[n][e] = a.o[n][e] * fa[e >> 1] + x[(n * 4 + e) * 32] * fx[e >> 1];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a.l[r] += __shfl_xor_sync(0xffffffffu, a.l[r], 1);
    a.l[r] += __shfl_xor_sync(0xffffffffu, a.l[r], 2);
  }
}

// Normalise and write the rows of a group-0 warp (a row that saw no key:
// 0).
template <int HDMAX>
__device__ __forceinline__ void store_rows(const Smem& s, const Acc<HDMAX>& a,
                                           const Role& role,
                                           bf16* __restrict__ out, int nrows,
                                           int hd) {
  const int lane = threadIdx.x & 31, row0 = role.row0;
  if (role.group > 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= nrows) continue;
    const float inv = a.l[r] > 0.f ? 1.f / a.l[r] : 0.f;
    bf16* o = out + s.roff[row];
#pragma unroll
    for (int n = 0; n < HDMAX / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(
            a.o[n][2 * r] * inv, a.o[n][2 * r + 1] * inv);
    }
  }
}

// A CTA that walked one split of the key axis writes its rows' partials for
// attn::combine_kernel (max in natural-log units, sum, unnormalised P V):
// m_part, l_part (rows, nsplit), acc_part (rows, nsplit, hd), the output
// row being roff / hd.
template <int HDMAX>
__device__ __forceinline__ void store_split(const Smem& s, const Acc<HDMAX>& a,
                                            const Role& role, int nrows,
                                            int hd, int split, int nsplit,
                                            float* __restrict__ m_part,
                                            float* __restrict__ l_part,
                                            float* __restrict__ acc_part) {
  const int lane = threadIdx.x & 31, row0 = role.row0;
  if (role.group > 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= nrows) continue;
    const long long idx = (s.roff[row] / hd) * nsplit + split;
    if ((lane & 3) == 0) {
      m_part[idx] = a.m[r] == kNeg ? kNeg : a.m[r] * kLn2;
      l_part[idx] = a.l[r];
    }
    float* o = acc_part + idx * hd;
#pragma unroll
    for (int n = 0; n < HDMAX / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < hd)
        *reinterpret_cast<float2*>(o + d) =
            make_float2(a.o[n][2 * r], a.o[n][2 * r + 1]);
    }
  }
}

// Keys whose positions and offsets stage_positions put in shared memory.
struct StagedKeys {
  const int* pos;
  const long long* off;
  int lo;                          // the first staged key
  __device__ __forceinline__ int locate(int j, long long& o) const {
    o = off[j - lo];
    return pos[j - lo];
  }
};

// Stage the position and K/V offset of each key in [lo, hi) (at most the
// max_keys the CTA was carved for), several position loads in flight a
// thread. No K/V is read.
template <typename Keys>
__device__ __forceinline__ void stage_positions(const Smem& s,
                                                const Keys& keys, int lo,
                                                int hi) {
  constexpr int kUnroll = 4;
  const int n = hi - lo;
  for (int i0 = 0; i0 < n; i0 += kUnroll * blockDim.x) {
    int p[kUnroll];
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      off[u] = 0;
      p[u] = i < n ? keys.locate(lo + i, off[u]) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      if (i < n) {
        s.spos[i] = p[u];
        s.soff[i] = off[u];
      }
    }
  }
}

// After stage_positions and a barrier: mark the n staged keys no row with
// position in [qmin, qmax] may see (-1), then list the tiles of KW keys
// that keep one (first key of each into s.tiles, lo being the first staged
// key). Returns their count.
template <int KW>
__device__ __forceinline__ int live_tiles(const Smem& s, int lo, int n,
                                          int qmin, int qmax, bool causal,
                                          int window) {
  static_assert(32 % KW == 0, "a warp's 32 keys hold whole tiles");
  constexpr unsigned kMask = KW == 32 ? 0xffffffffu : (1u << KW) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (n + KW - 1) / KW;
  for (int base = warp * 32; base < n; base += blockDim.x) {
    const int i = base + lane;
    bool live = false;
    if (i < n) {
      live = key_live(s.spos[i], qmin, qmax, causal, window);
      if (!live) s.spos[i] = -1;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    const int t = base / KW + lane;
    if (lane < 32 / KW && t < nt) s.tiles[t] = (bal >> (lane * KW)) & kMask;
  }
  __syncthreads();
  if (warp == 0) {                   // compact in place, in order
    int m = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      const bool f = t < nt && s.tiles[t] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) s.tiles[m + __popc(bal & ((1u << lane) - 1u))] = lo + t * KW;
      m += __popc(bal);
    }
    if (lane == 0) s.misc[0] = m;
  }
  __syncthreads();
  return s.misc[0];
}

// [min, max] of s.qpos over rows [0, nrows <= 64), in every warp.
__device__ __forceinline__ void row_bounds(const Smem& s, int nrows,
                                           int& qmin, int& qmax) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = lane; r < nrows; r += 32) {
    lo = min(lo, s.qpos[r]);
    hi = max(hi, s.qpos[r]);
  }
  qmin = __reduce_min_sync(0xffffffffu, lo);
  qmax = __reduce_max_sync(0xffffffffu, hi);
}

// -- the decode kernels' CTA (ring and paged) --------------------------------

// keys per warp tile: 32, or 16 above 128 dims (a stage of 4 warp tiles then
// fits twice in shared memory)
template <int HDMAX>
constexpr int kDecodeWarpKeys = HDMAX <= 128 ? 32 : 16;

// query rows of a decode CTA in warp row tiles, and the warps (groups) that
// split each stage's keys: 4 warps in all, or 3 row tiles alone
__host__ __device__ inline int decode_groups(int row_tiles) {
  return row_tiles == 3 ? 1 : 4 / row_tiles;
}

// The launch of a bf16 decode kernel over a w-key axis in splits of
// split_len keys: grid (B * KV, row tiles of up to 64 rows, splits).
struct DecodeGrid {
  dim3 grid;
  int threads, nsplit;
  size_t smem;
};

template <int HDMAX>
inline DecodeGrid decode_grid(int b, int tq, int h, int kvh_n, int w,
                              int split_len) {
  constexpr int KW = kDecodeWarpKeys<HDMAX>;
  const int rows = tq * (h / kvh_n);
  const int row_tiles = min(4, (rows + 15) / 16);
  const int groups = decode_groups(row_tiles);
  const int rb = 16 * row_tiles;
  DecodeGrid d;
  d.nsplit = (w + split_len - 1) / split_len;
  d.grid = dim3(b * kvh_n, (rows + rb - 1) / rb, d.nsplit);
  d.threads = 32 * row_tiles * groups;
  d.smem = smem_bytes(rb, Shape<HDMAX>::kPitch, groups * KW, KW, split_len);
  return d;
}

// One CTA of a bf16 decode kernel: the T*G query rows of (slot b, KV head
// kvh) = blockIdx.x in its blockIdx.y-th tile of up to 64, over keys
// [split * split_len, + split_len) of the slot's w, each key located by
// `keys` (attn::StridedKeys, attn::PagedKeys). Q's copy is in flight while
// the rows' and the split's positions and K/V offsets are staged and the
// live tiles are listed. With one split the CTA writes the output rows,
// else its partials for attn::combine_kernel.
template <int HDMAX, typename Keys>
__device__ __forceinline__ void decode_cta(
    unsigned char* smem_raw, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ q_pos, const Keys& keys, bf16* __restrict__ out,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int b, int kvh, int tq, int h, int kvh_n,
    int w, int hd, int split_len, int window, float scale) {
  constexpr int KW = kDecodeWarpKeys<HDMAX>;
  using S = Shape<HDMAX>;
  const int row_tiles = min(4, (tq * (h / kvh_n) + 15) / 16);
  const int groups = decode_groups(row_tiles);
  const Role role(groups);
  const int rows_per_cta = row_tiles * 16;
  const int g = h / kvh_n, rows = tq * g;
  const int row0 = blockIdx.y * rows_per_cta;
  const int nrows = min(rows_per_cta, rows - row0);
  const int split = blockIdx.z, nsplit = gridDim.z;
  const Smem s = carve(smem_raw, rows_per_cta, S::kPitch, groups * KW, KW,
                       split_len);
  const int lo = split * split_len, hi = min(w, lo + split_len);
  decode_rows(s.roff, nullptr, nullptr, b, kvh, tq, h, g, hd, row0, nrows);
  __syncthreads();
  load_q<HDMAX>(s, q, nrows, rows_per_cta, hd);
  decode_rows(nullptr, s.qpos, q_pos, b, kvh, tq, h, g, hd, row0, nrows);
  stage_positions(s, keys, lo, hi);
  __syncthreads();
  int qmin, qmax;
  row_bounds(s, nrows, qmin, qmax);
  const int ntiles = live_tiles<KW>(s, lo, hi - lo, qmin, qmax,
                                    /*causal=*/true, window);
  const StagedKeys staged{s.spos, s.soff, lo};
  Acc<HDMAX> acc;
  attend<HDMAX, KW>(s, q, k, v, staged, nrows, hd, lo, hi, s.tiles, ntiles,
                    groups, qmin, qmax, /*causal=*/true, window, scale, acc);
  if (nsplit == 1)
    store_rows<HDMAX>(s, acc, role, out, nrows, hd);
  else
    store_split<HDMAX>(s, acc, role, nrows, hd, split, nsplit, m_part, l_part,
                       acc_part);
}

}  // namespace mma
}  // namespace attn
