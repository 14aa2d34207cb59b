// Device pieces of the split tree-verify walk on the tensor cores, shared by
// the dense verify (verify_attention.cu, B1), the fused and the cache-only
// paged walks (paged_attention.cu, B2 and B3) and the normalized tree
// kernel (tree_partial.cu, B5) under bf16 queries: cp.async staging into a
// three-stage shared-memory ring, ldmatrix fragments, mma.sync products
// with fp32 accumulation, the masked online softmax in registers, the
// partials' store, the Eq.-1 merge kernel and the carry fold.
//
// The grid of a call is (B*Hkv, row tiles, parts).  Block (x, y, z) takes
// kv head h of batch row b (x = b*Hkv + h), the query rows [y*R, ...) of
// its G*W (R = kRows for the walks over the cache; row r = g*W + w reads
// query head h*G + g, the reference's grouping), and one contiguous range
// of cache slots, the W fresh tree KVs under the ancestor mask, or both
// (split_block: the tree is a part of its own when it spans more than one
// tile, else the last split's block walks it after its slots;
// cache_block: slots only).  It writes the unnormalized fp32 partial
// (o, m, l) of its part into a workspace in the cm.merge_partials layout,
// part-major; merge_kernel then folds the parts into o / max(l, 1e-30) in
// q's dtype (B1, B2), or carry_fold_kernel into one unnormalized partial
// (B3).  A part that sees no valid key writes o = 0, l = 0,
// m = kNegInf / 2, which the merge weighs by exactly 0 next to a part that
// sees one (the tree part always holds the node itself).  tree_block (B5)
// walks the tree alone and stores o / max(l, 1e-30) from its registers.
//
// Inside a block each of the kWarps warps owns 16 query rows (with <= 32
// rows a block the warps share rows and split each key tile: Rows): their Q
// fragments, O accumulator and row m, l stay in registers for the whole
// walk.  Keys come in tiles of kTile; per tile a warp computes S = Q K^T
// (m16n8k16, K fragments by ldmatrix from bf16 rows padded by 16 bytes, so
// the eight 16-byte rows of one ldmatrix land in eight distinct bank
// groups), masks each element from its own (row, key) coordinates, updates
// m and l with quad-lane shuffles, rounds P to bf16 and adds P V (V
// fragments by ldmatrix.trans).  Scores outside the mask are the finite
// kNegInf and their probabilities exactly 0, as in attention_common.cuh.
//
// Staging (walk): a tile's key positions (and block-table entries) are
// copied into shared memory with 4-byte cp.async five iterations ahead,
// resolved into each slot's element offset three ahead, and its K/V
// copied with 16-byte cp.async.cg two ahead, so no thread stalls on a
// global read; a skipped slot (empty, past the split, or on an unreserved
// page) is zero-filled by the copy's src-size 0 form and never read.
// Tiles i+1 and i+2 are in flight while tile i computes; each tile costs
// one cp.async.wait_group and one barrier, and a tile without a valid key
// is skipped.  An int8 pool is staged as codes and dequantized (code x
// the per-(page, kv head) scale, rounded to bf16) into the compute tile
// after that barrier, with one more barrier.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;            // keys per tile
constexpr int kRows = 16 * kWarps;   // query rows per block
constexpr int kHdMax = 128;          // head_dim the register tiles hold

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src-size 0 writes 16 zero bytes and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- layout
// Byte offsets of one block's dynamic shared memory.  Ring stage s holds
// the K tile then the V tile, kTile rows of `ld` bf16 (head_dim rounded up
// to 16, + 8 of pad).  An int8 walk stages its codes in the region of
// stages 1 .. kStages-1 (kStages stages of K and V codes, hd bytes a row:
// they fit, since kStages * hd <= (kStages - 1) * 2 * (hd + 8)) and
// dequantizes each tile into stage 0.
//
// A tile's slot metadata moves through kMeta slots: its key positions and
// block-table entries are copied (cp.async) 5 iterations before it is
// computed, resolved 3 before (each slot's element offset and key
// position, -1 = not read; an int8 pool's scales copied), its K/V copies
// issued 2 before.
constexpr int kStages = 3;   // K/V ring: two tiles in flight
constexpr int kMeta = 6;     // metadata slots: tiles i .. i + 5

struct Layout {
  int ld;            // bf16 elements per K/V row
  size_t stage;      // bytes of one stage (K and V)
  size_t off;        // int64[kMeta][kTile]: element offset per slot, or -1
  size_t kp_raw;     // int[kMeta][kTile]: key_pos as copied
  size_t tbl_raw;    // int[kMeta][kTile]: block-table entry as copied
  size_t bits;       // uint32[kMeta][kRows][2]: tree-mask bits per row (the
                     // tree walk has no raw metadata: kp_raw's place)
  size_t kp;         // int[kMeta][kTile]: key position of a read slot, or -1
  size_t ksc, vsc;   // float[kMeta][kTile]: int8 dequant scales per slot
  size_t total;
};

// 115,200 bytes at hd = 128: two blocks share an SM's 228 KB.
__host__ __device__ inline Layout layout(int hd) {
  Layout L;
  L.ld = (hd + 15) / 16 * 16 + 8;
  L.stage = 2 * (size_t)kTile * L.ld * 2;
  size_t o = kStages * L.stage;
  const size_t per = (size_t)kMeta * kTile * 4;
  static_assert(kRows == kTile, "the tree-mask bits fill kp_raw + tbl_raw");
  L.off = o;
  L.kp_raw = L.bits = o += 2 * per;
  L.tbl_raw = o += per;
  L.kp = o += per;
  L.ksc = o += per;
  L.vsc = o += per;
  L.total = o + per;
  return L;
}

// One metadata slot's arrays.
struct Meta {
  long long* off;
  int *kp_raw, *tbl_raw, *kp;
  float *ksc, *vsc;
  uint32_t* bits;
};

// 4-byte async copy global -> shared (src-size 0: writes zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// ---------------------------------------------------------------- warp
// One warp's 16 query rows (lane holds rows lane/4 and lane/4 + 8) and
// its share of each key tile.  With <= 16 rows a block all four warps hold
// the same rows and split every tile four ways (<= 32 rows: two ways), so
// the products of a small verify or decode (or a small row tile of B5) run
// on four warps, not one; the groups' (o, m, l) are folded at the end
// (fold_rows).
struct Rows {
  uint32_t q[kHdMax / 16][4];   // A fragments of Q
  float o[kHdMax / 8][4];       // C fragments of O
  float m[2], l[2];             // running max, this lane's share of the sum
  int qpos[2], lo[2];           // per row; qpos = -1 for a padded row
  int qmin, lomax;              // over the warp's rows (the full-tile test)
  int lr0;                      // the warp's first row in the block
  int key0;                     // the warp's first key of a tile
  int group, groups;            // key group, key groups per row group
};

// Everything a block needs to know about its place and its rows.
struct Block {
  int b, h, W, Hq, Hkv, G, hd, r0, nr;
  float scale;
};

// Block (blockIdx.x = b*Hkv + h, blockIdx.y) of `rows` (<= kRows) query
// rows a block.
__device__ __forceinline__ Block make_block(int Hkv, int W, int Hq, int hd,
                                            int rows, float scale) {
  Block k;
  k.b = blockIdx.x / Hkv;
  k.h = blockIdx.x % Hkv;
  k.W = W;
  k.Hq = Hq;
  k.Hkv = Hkv;
  k.G = Hq / Hkv;
  k.hd = hd;
  k.r0 = blockIdx.y * rows;
  k.nr = min(rows, k.G * W - k.r0);
  k.scale = scale;
  return k;
}

// ---------------------------------------------------------------- slots
// A policy copies a tile's raw metadata (copy_meta, cp.async), then
// resolves slot t (logical slot j) from it: read or not, its element
// offset (of its element 0) and key position, and an int8 pool's scales.

// Dense per-row ring cache (B, S, Hkv, hd): filled slots (key_pos >= 0).
template <typename T>
struct DenseSlots {
  using E = T;
  static constexpr bool kTree = false;
  const T *k, *v;
  const int* key_pos;  // (B, S)
  int b, h, S, Hkv, hd;
  __device__ __forceinline__ void copy_meta(const Meta& m, int j0,
                                            int len) const {
    for (int t = threadIdx.x; t < len; t += kThreads)
      cp_async4(m.kp_raw + t, key_pos + (size_t)b * S + j0 + t, true);
  }
  __device__ __forceinline__ void resolve(const Meta& m, int t, int j,
                                          const Block&) const {
    const int kp = m.kp_raw[t];
    m.kp[t] = kp >= 0 ? kp : -1;
    m.off[t] = kp >= 0 ? ((long long)(b * S + j) * Hkv + h) * hd : -1;
  }
};

// Shared page pool (P, ps, Hkv, hd) through the block table: slots on a
// reserved page (table entry >= 0) with key_pos >= 0.
template <typename T>
struct PagedSlots {
  using E = T;
  static constexpr bool kTree = false;
  const T *k, *v;
  const float *sk, *sv;  // (P, Hkv) int8 scales, or null
  const int* table;      // (B, maxp)
  const int* key_pos;    // (B, maxp * ps)
  int b, h, ps, maxp, Hkv, hd;
  __device__ __forceinline__ void copy_meta(const Meta& m, int j0,
                                            int len) const {
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int j = j0 + t;
      cp_async4(m.kp_raw + t, key_pos + (size_t)b * maxp * ps + j, true);
      cp_async4(m.tbl_raw + t, table + b * maxp + j / ps, true);
    }
  }
  __device__ __forceinline__ void resolve(const Meta& m, int t, int j,
                                          const Block&) const {
    const int page = m.tbl_raw[t], kp = m.kp_raw[t];
    const bool ok = page >= 0 && kp >= 0;
    m.kp[t] = ok ? kp : -1;
    m.off[t] = ok ? ((long long)page * ps + j % ps) * Hkv * hd + h * hd : -1;
    if (sizeof(T) == 1) {   // the page's int8 scales, for the dequant
      const size_t i = ok ? (size_t)page * Hkv + h : 0;
      cp_async4(m.ksc + t, sk + i, ok);
      cp_async4(m.vsc + t, sv + i, ok);
    }
  }
};

// The W fresh tree KVs (B, W, Hkv, hd), masked by the W x W ancestor mask.
struct TreeSlots {
  using E = __nv_bfloat16;
  static constexpr bool kTree = true;
  const E *k, *v;
  const uint8_t* mask;  // (W, W) bool
  int b, h, W, Hkv, hd;
  __device__ __forceinline__ void copy_meta(const Meta&, int, int) const {}
  // slot t's offset (its mask bits: resolve_bits)
  __device__ __forceinline__ void resolve(const Meta& m, int t, int j,
                                          const Block&) const {
    m.kp[t] = j;
    m.off[t] = ((long long)(b * W + j) * Hkv + h) * hd;
  }
  // mask bits of the block's rows for keys j0 .. j0 + len - 1
  __device__ __forceinline__ void resolve_bits(const Meta& m, int j0,
                                               int len,
                                               const Block& k) const {
    for (int x = threadIdx.x; x < kRows * 2; x += kThreads) {
      const int lr = x / 2, half = x % 2;
      uint32_t word = 0;
      if (lr < k.nr) {
        const uint8_t* mrow = mask + (size_t)((k.r0 + lr) % W) * W + j0;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int t = half * 32 + e;
          if (t < len && __ldg(mrow + t)) word |= 1u << e;
        }
      }
      m.bits[lr * 2 + half] = word;
    }
  }
};

// The warp's rows and keys, then its rows' Q fragments from q (B, W, Hq,
// hd) (zero past hd or past the block's rows), q_pos and lo (null for a
// walk of the tree alone, which reads neither: qpos = 0 then marks a real
// row).
__device__ __forceinline__ void load_rows(Rows& R, const Block& k,
                                          const __nv_bfloat16* q,
                                          const int* q_pos, const int* lo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_warps = k.nr <= 16 ? 1 : k.nr <= 32 ? 2 : kWarps;
  R.groups = kWarps / row_warps;
  R.group = warp / row_warps;
  R.lr0 = (warp % row_warps) * 16;
  R.key0 = R.group * (kTile / R.groups);
  const int nkb = (k.hd + 15) / 16;
  int qmin = 0x7fffffff, lomax = -0x7fffffff;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int lr = R.lr0 + lane / 4 + 8 * e;
    const int r = k.r0 + lr;
    const bool ok = lr < k.nr;
    const int g = ok ? r / k.W : 0, w = ok ? r % k.W : 0;
    R.qpos[e] = !ok ? -1 : q_pos ? __ldg(q_pos + k.b * k.W + w) : 0;
    R.lo[e] = ok && lo ? __ldg(lo + k.b * k.W + w) : 0;
    if (ok) {
      qmin = min(qmin, R.qpos[e]);
      lomax = max(lomax, R.lo[e]);
    }
    R.m[e] = kNegInf;
    R.l[e] = 0.f;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + ((size_t)(k.b * k.W + w) * k.Hq + k.h * k.G + g) * k.hd);
#pragma unroll
    for (int kb = 0; kb < kHdMax / 16; ++kb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = kb * 16 + half * 8 + (lane % 4) * 2;
        uint32_t v = 0;
        if (ok && kb < nkb && col < k.hd) v = __ldg(qr + col / 2);
        R.q[kb][e + 2 * half] = v;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    lomax = max(lomax, __shfl_xor_sync(0xffffffffu, lomax, o));
  }
  R.qmin = qmin;
  R.lomax = lomax;
#pragma unroll
  for (int nb = 0; nb < kHdMax / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) R.o[nb][e] = 0.f;
}

// The warp's KN keys [key0, key0 + KN) of one staged tile (K, V bf16 rows
// of `ld`) through its rows.  FULL: every key is valid for every row (no
// per-element mask); else valid(e, t) says whether row e (0: lane/4, 1:
// lane/4 + 8) sees key t of the tile.
//
// PRECISE (the cache-only walk, whose unnormalized fp32 partial is held to
// the plain version's at an absolute tolerance): P enters P V as two bf16
// terms, hi = bf16(p) and lo = bf16(p - hi), so P keeps ~16 bits; and an
// int8 tile holds its codes exactly (ksc, vsc: the warp's keys' scales,
// else null), so each score is scaled by its key's K scale after Q K^T
// and each p by its key's V scale before the split, all in fp32.
template <int KN, bool FULL, bool PRECISE, class Valid>
__device__ __forceinline__ void attend(Rows& R, const __nv_bfloat16* Ks,
                                       const __nv_bfloat16* Vs, int ld,
                                       int hd, float scale,
                                       const Valid& valid,
                                       const float* ksc, const float* vsc) {
  const int lane = threadIdx.x % 32;
  const int nkb = (hd + 15) / 16;
  Ks += R.key0 * ld;
  Vs += R.key0 * ld;
  float s[KN / 8][4];
#pragma unroll
  for (int nb = 0; nb < KN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;

  // S = Q K^T: per 16 of head_dim, two 8-key blocks per ldmatrix.x4
#pragma unroll
  for (int kb = 0; kb < kHdMax / 16; ++kb) {
    if (kb >= nkb) break;
#pragma unroll
    for (int np = 0; np < KN / 16; ++np) {
      uint32_t bk[4];
      ldsm_x4(bk, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                      kb * 16 + (((lane >> 3) & 1) << 3));
      mma(s[2 * np], R.q[kb], bk[0], bk[1]);
      mma(s[2 * np + 1], R.q[kb], bk[2], bk[3]);
    }
  }

  // key of element (nb, e) among the warp's keys
  auto key = [&](int nb, int e) { return nb * 8 + (lane & 3) * 2 + (e & 1); };
  if (PRECISE && ksc != nullptr) {
#pragma unroll
    for (int nb = 0; nb < KN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= ksc[key(nb, e)];
  }

  // mask, online softmax (a row's four lanes are one quad)
  float mx[2] = {kNegInf, kNegInf};
  uint32_t ok[2] = {0u, 0u};
#pragma unroll
  for (int nb = 0; nb < KN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1;
      if (FULL || valid(row, R.key0 + nb * 8 + (lane & 3) * 2 + (e & 1))) {
        ok[row] |= 1u << (nb * 2 + (e & 1));
        s[nb][e] *= scale;
        mx[row] = fmaxf(mx[row], s[nb][e]);
      } else {
        s[nb][e] = kNegInf;
      }
    }
  float corr[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
    mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
    const float m_new = fmaxf(R.m[row], mx[row]);
    corr[row] = __expf(R.m[row] - m_new);
    R.m[row] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < KN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1;
      const float p = FULL || ((ok[row] >> (nb * 2 + (e & 1))) & 1u)
                          ? __expf(s[nb][e] - R.m[row])
                          : 0.f;
      s[nb][e] = p;
      sum[row] += p;
    }
#pragma unroll
  for (int row = 0; row < 2; ++row)
    R.l[row] = R.l[row] * corr[row] + sum[row];
  // the running max moved for some row of the warp: rescale O
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int nb = 0; nb < kHdMax / 8; ++nb) {
      R.o[nb][0] *= corr[0];
      R.o[nb][1] *= corr[0];
      R.o[nb][2] *= corr[1];
      R.o[nb][3] *= corr[1];
    }
  }

  // O += P V: P's C fragments of two 8-key blocks are one A fragment
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    uint32_t pa[4], lo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int nb = 2 * kk + (x >> 1), e = (x & 1) * 2;
      float p0 = s[nb][e], p1 = s[nb][e + 1];
      if (PRECISE && vsc != nullptr) {
        p0 *= vsc[key(nb, e)];
        p1 *= vsc[key(nb, e + 1)];
      }
      pa[x] = pack_bf16(p0, p1);
      if constexpr (PRECISE) {
        const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&pa[x]);
        lo[x] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
    }
#pragma unroll
    for (int dp = 0; dp < kHdMax / 16; ++dp) {
      if (dp >= nkb) break;
      uint32_t bv[4];
      ldsm_x4_t(bv, Vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                             ld + dp * 16 + ((lane >> 4) << 3));
      mma(R.o[2 * dp], pa, bv[0], bv[1]);
      mma(R.o[2 * dp + 1], pa, bv[2], bv[3]);
      if constexpr (PRECISE) {
        mma(R.o[2 * dp], lo, bv[0], bv[1]);
        mma(R.o[2 * dp + 1], lo, bv[2], bv[3]);
      }
    }
  }
}

// One tile through the warp's KN keys: the full-tile test, then attend.
template <int KN, class P, bool PRECISE>
__device__ __forceinline__ void attend_tile(Rows& R, const Meta& m,
                                            const __nv_bfloat16* Ks,
                                            const __nv_bfloat16* Vs, int ld,
                                            const Block& k) {
  const int lane = threadIdx.x % 32;
  if constexpr (P::kTree) {
    const uint32_t* bits = m.bits + (R.lr0 + lane / 4) * 2;
    const uint32_t w0[2] = {bits[0], bits[1]};
    const uint32_t w1[2] = {bits[16], bits[17]};   // row + 8
    // full: every bit of the warp's keys set for every real row
    auto row_full = [&](const uint32_t* wd) {
      if (KN == 64) return (wd[0] & wd[1]) == 0xffffffffu;
      const uint32_t want =
          KN == 32 ? 0xffffffffu : ((1u << (KN & 31)) - 1u) << (R.key0 & 31);
      return (wd[R.key0 >> 5] & want) == want;
    };
    const bool full =
        __all_sync(0xffffffffu, (R.qpos[0] < 0 || row_full(w0)) &&
                                    (R.qpos[1] < 0 || row_full(w1)));
    auto valid = [&](int e, int t) {
      const uint32_t* wd = e ? w1 : w0;
      return ((wd[t >> 5] >> (t & 31)) & 1u) != 0u;
    };
    if (full)
      attend<KN, true, PRECISE>(R, Ks, Vs, ld, k.hd, k.scale, valid, nullptr,
                                nullptr);
    else
      attend<KN, false, PRECISE>(R, Ks, Vs, ld, k.hd, k.scale, valid,
                                 nullptr, nullptr);
  } else {
    const int* kps = m.kp;
    auto valid = [&](int e, int t) {
      const int kp = kps[t];
      return kp >= 0 && kp <= R.qpos[e] && kp > R.lo[e];
    };
    bool f = true;
    for (int t = lane; t < KN; t += 32) {
      const int kp = kps[R.key0 + t];
      f = f && kp >= 0 && kp <= R.qmin && kp > R.lomax;
    }
    // a precise int8 tile holds codes: its keys' scales come along
    const bool codes = PRECISE && sizeof(typename P::E) == 1;
    const float* ksc = codes ? m.ksc + R.key0 : nullptr;
    const float* vsc = codes ? m.vsc + R.key0 : nullptr;
    if (__all_sync(0xffffffffu, f))
      attend<KN, true, PRECISE>(R, Ks, Vs, ld, k.hd, k.scale, valid, ksc,
                                vsc);
    else
      attend<KN, false, PRECISE>(R, Ks, Vs, ld, k.hd, k.scale, valid, ksc,
                                 vsc);
  }
}

// The walk over slots [j_begin, j_end) of policy P through the kStages
// ring; every thread stages, the warps that hold rows compute.
// `start` runs while the first two tiles' copies are in flight.
// Iteration i: wait for tile i's copies; one barrier; issue tile i + 2's
// K/V copies from its resolved offsets (one 8-byte read of shared memory
// per 16-byte copy), resolve tile i + 3's metadata, copy tile i + 5's raw
// metadata, as one commit group; dequantize (int8); compute tile i.  No
// thread waits on a global read outside the cp.async groups, except the
// tree's mask bits.
template <bool PRECISE = false, class P, class Start>
__device__ __forceinline__ void walk(Rows& R, const Block& k, const P& p,
                                     char* smem, const Layout& L,
                                     int j_begin, int j_end,
                                     const Start& start) {
  using E = typename P::E;
  constexpr bool kInt8 = sizeof(E) == 1;
  const int tid = threadIdx.x, lane = tid % 32;
  const int hd = k.hd, ld = L.ld;
  const int n_tiles = (j_end - j_begin + kTile - 1) / kTile;
  char* raw = smem + L.stage;   // int8 codes: kStages stages after stage 0
  const size_t raw_stage = 2 * (size_t)kTile * hd;
  // this thread's 16-byte chunks of a tile: (t, c), stepping by kThreads
  const int nch = hd * (int)sizeof(E) / 16;
  const int t0 = tid / nch, c0 = tid % nch;
  const int dt = kThreads / nch, dc = kThreads % nch;

  auto meta = [&](int i) {
    const int ms = i % kMeta;
    const size_t o = (size_t)ms * kTile * 4;
    Meta m;
    m.off = reinterpret_cast<long long*>(smem + L.off) + ms * kTile;
    m.kp_raw = reinterpret_cast<int*>(smem + L.kp_raw + o);
    m.tbl_raw = reinterpret_cast<int*>(smem + L.tbl_raw + o);
    m.kp = reinterpret_cast<int*>(smem + L.kp + o);
    m.ksc = reinterpret_cast<float*>(smem + L.ksc + o);
    m.vsc = reinterpret_cast<float*>(smem + L.vsc + o);
    m.bits = reinterpret_cast<uint32_t*>(smem + L.bits) + ms * kRows * 2;
    return m;
  };
  auto tile_len = [&](int i) {
    return min(kTile, j_end - j_begin - i * kTile);
  };
  auto copy_meta = [&](int i) {
    if (i < n_tiles) p.copy_meta(meta(i), j_begin + i * kTile, tile_len(i));
  };
  auto resolve = [&](int i) {
    if (i >= n_tiles) return;
    const Meta m = meta(i);
    const int j0 = j_begin + i * kTile, len = tile_len(i);
    for (int t = tid; t < kTile; t += kThreads) {
      if (t < len) {
        p.resolve(m, t, j0 + t, k);
      } else {
        m.kp[t] = -1;
        m.off[t] = -1;
        // the dequant reads every slot's scales: a stale Inf or NaN there
        // times a zero-filled code would put a NaN into the V tile, and
        // 0 x NaN into every row's P V
        if constexpr (kInt8) m.ksc[t] = m.vsc[t] = 0.f;
      }
    }
    if constexpr (P::kTree) p.resolve_bits(m, j0, len, k);
  };
  // tile i's K/V copies into ring slot i % kStages; a slot not read is
  // zero-filled
  auto issue = [&](int i) {
    if (i >= n_tiles) return;
    const long long* off = meta(i).off;
    const int st = i % kStages;
    char* kdst = kInt8 ? raw + st * raw_stage : smem + st * L.stage;
    char* vdst = kInt8 ? kdst + kTile * hd : kdst + (size_t)kTile * ld * 2;
    const int row_bytes = kInt8 ? hd : ld * 2;
    auto copy = [&](int t, int c) {
      const long long o = off[t];
      const size_t src = o >= 0 ? (size_t)o + (size_t)c * (16 / sizeof(E)) : 0;
      cp_async16(kdst + t * row_bytes + c * 16, p.k + src, o >= 0);
      cp_async16(vdst + t * row_bytes + c * 16, p.v + src, o >= 0);
    };
    if (dc == 0) {   // head_dim 16, 32, 64, 128 (bf16): whole rows a step
#pragma unroll 4
      for (int t = t0; t < kTile; t += dt) copy(t, c0);
    } else {
      for (int t = t0, c = c0; t < kTile;) {
        copy(t, c);
        t += dt;
        c += dc;
        if (c >= nch) {
          c -= nch;
          ++t;
        }
      }
    }
  };

  __syncthreads();   // a walk after another: every warp is done with it
  for (int i = 0; i < 5; ++i) copy_meta(i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = 0; i < 3; ++i) resolve(i);
  __syncthreads();
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();
  start();   // the rows' global reads, while tiles 0 and 1 are in flight
  for (int i = 0; i < n_tiles; ++i) {
    const Meta m = meta(i);
    cp_async_wait<kStages - 2>();
    // tile i (and its scales) is in shared memory, every warp is done with
    // tile i - 1, tile i + 2 is resolved, tile i + 3's raw metadata is in
    __syncthreads();
    issue(i + 2);
    resolve(i + 3);
    copy_meta(i + 5);
    cp_async_commit();   // an empty group past the end keeps the count
    // skip a tile without a valid key: block-uniform for the cache (every
    // warp reads the same key positions), per warp for the tree
    bool any;
    if constexpr (P::kTree) {
      any = __any_sync(0xffffffffu,
                       m.bits[(R.lr0 + lane / 2) * 2 + (lane & 1)] != 0u);
    } else {
      any = __any_sync(0xffffffffu, m.kp[lane] >= 0 || m.kp[lane + 32] >= 0);
    }
    if (!any) continue;
    const __nv_bfloat16* Ks;
    if constexpr (kInt8) {
      // codes x scale, rounded to bf16, into stage 0 (PRECISE: the codes
      // alone, exact in bf16; attend applies the scales in fp32)
      const int8_t* k8 =
          reinterpret_cast<const int8_t*>(raw + (i % kStages) * raw_stage);
      const int8_t* v8 = k8 + kTile * hd;
      __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(smem);
      __nv_bfloat16* vb = kb + kTile * ld;
      const int n8 = hd / 8;
      for (int x = tid; x < kTile * n8; x += kThreads) {
        const int t = x / n8, c = (x % n8) * 8;
        const float ksc = PRECISE ? 1.f : m.ksc[t];
        const float vsc = PRECISE ? 1.f : m.vsc[t];
        const int2 kc = *reinterpret_cast<const int2*>(k8 + t * hd + c);
        const int2 vc = *reinterpret_cast<const int2*>(v8 + t * hd + c);
        const int8_t* ke = reinterpret_cast<const int8_t*>(&kc);
        const int8_t* ve = reinterpret_cast<const int8_t*>(&vc);
        uint4 ko, vo;
        uint32_t* kw = reinterpret_cast<uint32_t*>(&ko);
        uint32_t* vw = reinterpret_cast<uint32_t*>(&vo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kw[e] = pack_bf16((float)ke[2 * e] * ksc, (float)ke[2 * e + 1] * ksc);
          vw[e] = pack_bf16((float)ve[2 * e] * vsc, (float)ve[2 * e + 1] * vsc);
        }
        *reinterpret_cast<uint4*>(kb + t * ld + c) = ko;
        *reinterpret_cast<uint4*>(vb + t * ld + c) = vo;
      }
      __syncthreads();
      Ks = kb;
    } else {
      Ks = reinterpret_cast<const __nv_bfloat16*>(smem +
                                                  (i % kStages) * L.stage);
    }
    const __nv_bfloat16* Vs = Ks + kTile * ld;
    if (R.lr0 >= k.nr) continue;
    if (R.groups == 4)
      attend_tile<kTile / 4, P, PRECISE>(R, m, Ks, Vs, ld, k);
    else if (R.groups == 2)
      attend_tile<kTile / 2, P, PRECISE>(R, m, Ks, Vs, ld, k);
    else
      attend_tile<kTile, P, PRECISE>(R, m, Ks, Vs, ld, k);
  }
  cp_async_wait<0>();
}

// Zero the pad columns [hd, round_up(hd, 16)) of every ring stage: no
// copy writes them, and the products read them.
__device__ __forceinline__ void zero_pad(char* smem, const Layout& L,
                                         int hd) {
  const int hd16 = (hd + 15) / 16 * 16;
  if (hd16 == hd) return;
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);
  const int pad = hd16 - hd;
  for (int x = threadIdx.x; x < 2 * kStages * kTile * pad; x += kThreads) {
    const int row = x / pad, c = hd + x % pad;   // K, V of every stage
    base[row * L.ld + c] = __float2bfloat16(0.f);
  }
}

// Fold the warps' key groups and reduce each row's l over its quad: with
// key groups, every warp first parks its (o, m, l) in the ring's shared
// memory; then the `groups` warps of a row group fold them (the Eq.-1
// merge, lane by lane: every group's lane holds the same rows and columns)
// for one share of the columns each.  Only the n-blocks that head_dim
// fills are parked: kWarps x (4 * nbs + 4) x 32 floats, 2,048 * (2 * nkb +
// 1) bytes, which the ring's 12,288 * nkb + 6,144 always holds (parking
// all kHdMax columns would overrun a block of head_dim 16).  Returns the
// warp's share of the n-blocks, [x, y).
__device__ __forceinline__ int2 fold_rows(Rows& R, const Block& k,
                                          char* smem) {
  constexpr int kNb = kHdMax / 8;        // n-blocks of O the registers hold
  const int nbs = (k.hd + 15) / 16 * 2;  // n-blocks head_dim fills
  const int regs = nbs * 4 + 4;          // parked: o, then m[2], l[2]
  const int lane = threadIdx.x % 32, rw = R.lr0 / 16;
  const int row_warps = kWarps / R.groups;
  int nb0 = 0, nb1 = kNb;
  if (R.groups > 1) {
    float* buf = reinterpret_cast<float*>(smem);
    __syncthreads();   // every warp is done with the ring
    float* mine = buf + (R.group * row_warps + rw) * regs * 32;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      if (nb >= nbs) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(nb * 4 + e) * 32 + lane] = R.o[nb][e];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mine[(regs - 4 + e) * 32 + lane] = R.m[e];
      mine[(regs - 2 + e) * 32 + lane] = R.l[e];
    }
    __syncthreads();
    nb0 = R.group * nbs / R.groups;
    nb1 = (R.group + 1) * nbs / R.groups;
    float c[kWarps][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m_star = kNegInf;
#pragma unroll
      for (int g = 0; g < kWarps; ++g)
        if (g < R.groups)
          m_star = fmaxf(m_star, buf[((g * row_warps + rw) * regs + regs -
                                      4 + e) * 32 + lane]);
      float l = 0.f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) {
        const float* src = buf + (g * row_warps + rw) * regs * 32;
        c[g][e] = g < R.groups
                      ? __expf(src[(regs - 4 + e) * 32 + lane] - m_star)
                      : 0.f;
        if (g < R.groups) l += src[(regs - 2 + e) * 32 + lane] * c[g][e];
      }
      R.m[e] = m_star;
      R.l[e] = l;
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      if (nb < nb0 || nb >= nb1) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float acc = 0.f;
#pragma unroll
        for (int g = 0; g < kWarps; ++g)
          if (g < R.groups)
            acc += buf[((g * row_warps + rw) * regs + nb * 4 + e) * 32 +
                       lane] * c[g][e >> 1];
        R.o[nb][e] = acc;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    R.l[e] += __shfl_xor_sync(0xffffffffu, R.l[e], 1);
    R.l[e] += __shfl_xor_sync(0xffffffffu, R.l[e], 2);
  }
  return make_int2(nb0, nb1);
}

// The block's partial (o, m, l) of part `part` into the workspace:
// o (parts, B, W, Hq, hd) fp32, m and l (parts, B, Hq, W); m clamped to
// kNegInf / 2 (the reference's m_safe).  Each warp stores its share of
// the columns (fold_rows).  Part 0 of a one-part workspace is the
// cm.merge_partials layout itself.
__device__ __forceinline__ void store_part(Rows& R, const Block& k,
                                           char* smem, float* ws_o,
                                           float* ws_m, float* ws_l, int B,
                                           int part) {
  constexpr int kNb = kHdMax / 8;
  const int2 share = fold_rows(R, k, smem);
  const int lane = threadIdx.x % 32;
  const size_t n_o = (size_t)B * k.W * k.Hq * k.hd;
  const size_t n_m = (size_t)B * k.Hq * k.W;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int lr = R.lr0 + lane / 4 + 8 * e;
    if (lr >= k.nr) continue;
    const int r = k.r0 + lr, g = r / k.W, w = r % k.W;
    const int hq = k.h * k.G + g;
    float* o = ws_o + part * n_o + ((size_t)(k.b * k.W + w) * k.Hq + hq) * k.hd;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      if (nb >= share.x && nb < share.y && col < k.hd)
        *reinterpret_cast<float2*>(o + col) =
            make_float2(R.o[nb][2 * e], R.o[nb][2 * e + 1]);
    }
    if ((lane & 3) == 0 && R.group == 0) {
      const size_t idx = part * n_m + ((size_t)k.b * k.Hq + hq) * k.W + w;
      ws_m[idx] = fmaxf(R.m[e], kNegInf * 0.5f);
      ws_l[idx] = R.l[e];
    }
  }
}

// The block's rows normalized, o / max(l, 1e-30), in bf16 into `out`
// (B, W, Hq, hd) straight from the registers: a row that saw no key
// (l = 0) stores 0.
__device__ __forceinline__ void store_normalized(Rows& R, const Block& k,
                                                 char* smem,
                                                 __nv_bfloat16* out) {
  constexpr int kNb = kHdMax / 8;
  const int2 share = fold_rows(R, k, smem);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int lr = R.lr0 + lane / 4 + 8 * e;
    if (lr >= k.nr) continue;
    const int r = k.r0 + lr, g = r / k.W, w = r % k.W;
    const float inv = 1.0f / fmaxf(R.l[e], 1e-30f);
    uint32_t* o = reinterpret_cast<uint32_t*>(
        out + ((size_t)(k.b * k.W + w) * k.Hq + k.h * k.G + g) * k.hd);
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      const int col = nb * 8 + (lane & 3) * 2;
      if (nb >= share.x && nb < share.y && col < k.hd)
        o[col / 2] = pack_bf16(R.o[nb][2 * e] * inv, R.o[nb][2 * e + 1] * inv);
    }
  }
}

// One block of the split walk, grid (B*Hkv, row tiles, parts): kv head
// h of batch row b (x = b*Hkv + h), the kRows query rows [y*kRows, ...).
// parts == n_split + 1 (a tree wider than one tile: a W=256 prefill
// piece): block z == 0 walks the tree, z >= 1 the slots of split z - 1.
// parts == n_split (W <= kTile: verify and decode): block z walks split
// z, and the last split's block walks the tree after its slots, into the
// same partial, so no block is spent on one small tile.
template <class C>
__device__ __forceinline__ void split_block(
    char* smem, const C& cache, const TreeSlots& tree,
    const __nv_bfloat16* q, const int* q_pos, const int* lo, float* ws_o,
    float* ws_m, float* ws_l, int B, int Hq, int S, int nsplit,
    int split_len, int parts, float scale) {
  const Block k = make_block(tree.Hkv, tree.W, Hq, tree.hd, kRows, scale);
  const Layout L = layout(k.hd);
  zero_pad(smem, L, k.hd);
  Rows R;
  bool loaded = false;
  auto start = [&] {
    if (!loaded) load_rows(R, k, q, q_pos, lo);
    loaded = true;
  };
  const int z = blockIdx.z;
  const bool apart = parts > nsplit;
  const int split = apart ? z - 1 : z;
  if (split >= 0) {
    const int jb = split * split_len;
    walk(R, k, cache, smem, L, jb, min(S, jb + split_len), start);
  }
  if (split < 0 || (!apart && split == nsplit - 1))
    walk(R, k, tree, smem, L, 0, k.W, start);
  store_part(R, k, smem, ws_o, ws_m, ws_l, B, z);
}

// One block of the cache-only walk (B3), grid (B*Hkv, row tiles, n_split):
// the slots of split z = blockIdx.z, no tree, at any W (a W=256 piece has
// four row tiles), into part z of ws (n_split == 1: ws is the caller's
// (o, m, l) itself).  Its partial leaves unnormalized, so it walks
// PRECISE (attend): P in two bf16 terms, an int8 pool's scales in fp32.
template <class C>
__device__ __forceinline__ void cache_block(char* smem, const C& cache,
                                            const Block& k,
                                            const __nv_bfloat16* q,
                                            const int* q_pos, const int* lo,
                                            float* ws_o, float* ws_m,
                                            float* ws_l, int B, int S,
                                            int split_len) {
  const Layout L = layout(k.hd);
  zero_pad(smem, L, k.hd);
  Rows R;
  auto start = [&] { load_rows(R, k, q, q_pos, lo); };
  const int jb = blockIdx.z * split_len;
  walk<true>(R, k, cache, smem, L, jb, min(S, jb + split_len), start);
  store_part(R, k, smem, ws_o, ws_m, ws_l, B, blockIdx.z);
}

// One block of the normalized tree attention (B5), grid (B*Hkv, row
// tiles): the block's k.nr rows over the W tree KVs under the ancestor
// mask, then o / max(l, 1e-30) from the registers.  With 16 rows a block
// the four warps split each 64-key tile four ways (32 rows: two), so a
// small row tile still keeps every warp on the products.
__device__ __forceinline__ void tree_block(char* smem, const TreeSlots& tree,
                                           const Block& k,
                                           const __nv_bfloat16* q,
                                           __nv_bfloat16* out) {
  const Layout L = layout(k.hd);
  zero_pad(smem, L, k.hd);
  Rows R;
  auto start = [&] { load_rows(R, k, q, nullptr, nullptr); };
  walk(R, k, tree, smem, L, 0, k.W, start);
  store_normalized(R, k, smem, out);
}

// The Eq.-1 merge of `parts` partials into o / max(l, 1e-30) in q's
// layout (B, W, Hq, hd) and dtype: a thread per 4 elements of one
// (b, w, query head) row, so every load of a part is one 16-byte read.
// The same math as cm.merge_partials.
template <typename TQ>
__global__ void __launch_bounds__(128)
    merge_kernel(const float* ws_o, const float* ws_m, const float* ws_l,
                 int parts, TQ* out, int B, int W, int Hq, int hd) {
  const int per_row = hd / 4;
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= (long long)B * W * Hq * per_row) return;
  const int row = (int)(x / per_row), d = (int)(x % per_row) * 4;
  const int hq = row % Hq, w = (row / Hq) % W, b = row / (W * Hq);
  const size_t n_o = (size_t)B * W * Hq * hd, n_m = (size_t)B * Hq * W;
  const size_t mi = ((size_t)b * Hq + hq) * W + w;
  float m_star = ws_m[mi];
  for (int p = 1; p < parts; ++p) m_star = fmaxf(m_star, ws_m[p * n_m + mi]);
  float l_star = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* o = ws_o + (size_t)row * hd + d;
#pragma unroll 4
  for (int p = 0; p < parts; ++p) {
    const float c = expf(ws_m[p * n_m + mi] - m_star);
    l_star += ws_l[p * n_m + mi] * c;
    const float4 v = *reinterpret_cast<const float4*>(o + p * n_o);
    acc.x += v.x * c;
    acc.y += v.y * c;
    acc.z += v.z * c;
    acc.w += v.w * c;
  }
  const float inv = 1.0f / fmaxf(l_star, 1e-30f);
  TQ* dst = out + (size_t)row * hd + d;
  dst[0] = attn::from_f32<TQ>(acc.x * inv);
  dst[1] = attn::from_f32<TQ>(acc.y * inv);
  dst[2] = attn::from_f32<TQ>(acc.z * inv);
  dst[3] = attn::from_f32<TQ>(acc.w * inv);
}

// The carry fold of `parts` partials into ONE unnormalized partial (the
// cache-only walk, B3, when it is split over the cache): m* = max_p m_p,
// l* = sum_p l_p e^(m_p - m*), o* = sum_p o_p e^(m_p - m*) (the rule of
// cm.merge_partials_carry, part after part), m* clamped to kNegInf / 2.
// An all-masked row (every part at m = kNegInf / 2, l = 0, o = 0) keeps
// m = kNegInf / 2, l = 0, o = 0, so it still drops out of the caller's
// merge.  A thread per 4 elements of one (b, w, query head) row, as
// merge_kernel; the row's first thread writes m and l.
__global__ void __launch_bounds__(128)
    carry_fold_kernel(const float* ws_o, const float* ws_m,
                      const float* ws_l, int parts, float* o, float* m,
                      float* l, int B, int W, int Hq, int hd) {
  const int per_row = hd / 4;
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= (long long)B * W * Hq * per_row) return;
  const int row = (int)(x / per_row), d = (int)(x % per_row) * 4;
  const int hq = row % Hq, w = (row / Hq) % W, b = row / (W * Hq);
  const size_t n_o = (size_t)B * W * Hq * hd, n_m = (size_t)B * Hq * W;
  const size_t mi = ((size_t)b * Hq + hq) * W + w;
  float m_star = ws_m[mi];
  for (int p = 1; p < parts; ++p) m_star = fmaxf(m_star, ws_m[p * n_m + mi]);
  m_star = fmaxf(m_star, kNegInf * 0.5f);
  float l_star = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = ws_o + (size_t)row * hd + d;
#pragma unroll 4
  for (int p = 0; p < parts; ++p) {
    const float c = expf(ws_m[p * n_m + mi] - m_star);
    l_star += ws_l[p * n_m + mi] * c;
    const float4 v = *reinterpret_cast<const float4*>(src + p * n_o);
    acc.x += v.x * c;
    acc.y += v.y * c;
    acc.z += v.z * c;
    acc.w += v.w * c;
  }
  *reinterpret_cast<float4*>(o + (size_t)row * hd + d) = acc;
  if (d == 0) {
    m[mi] = m_star;
    l[mi] = l_star;
  }
}

}  // namespace flash
