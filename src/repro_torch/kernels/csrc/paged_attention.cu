// Paged verify attention over the shared KV page pool, fused (the page walk
// and the tree tile under one online softmax) or cache-only (unnormalized
// partials for the split verify).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/tree_attention.py:
//   * paged_tree_attention (TREE = true): computes exactly
//     src/repro_torch/kernels/plain.py::paged_tree_attention_plain;
//   * paged_cache_attention (TREE = false, body _cache_partial_kernel):
//     computes paged_cache_attention_plain, the (o, m, l) partials that the
//     caller merges with the tree half (tree_partial.cu) by Eq. 1.
//
// Both walks are the split design of verify_attention.cu over the pool: a
// grid of (B*Hkv, row tiles, parts) blocks, each walking a contiguous range
// of whole pages (the fused walk: the W tree nodes, or both) into an fp32
// (o, m, l) partial.  The fused walk (B2) then launches flash_common.cuh's
// merge_kernel (a second launch from the same entry point), which folds
// the parts by Eq. 1 into the normalized output.  The cache-only walk (B3)
// has no tree part (parts == n_split at every W) and must hand back ONE
// unnormalized partial: with one split its blocks store straight into the
// caller's (o, m, l); with more, into the workspace, and carry_fold_kernel
// (the second launch) folds the splits by the carry rule of
// cm.merge_partials_carry, leaving an all-masked row at l = 0,
// m = NEG_INF / 2.  The TPU kernel gets the block table by scalar prefetch
// and lets a BlockSpec index map DMA page table[b, i] at grid step i; here
// a tile's table entries and key positions are copied (cp.async) into
// shared memory a few tiles ahead, each slot's pool address resolved from
// them, and then its K/V copies issued: slot j lives at pool slot
// table[b, j/ps]*ps + j%ps of the (P, ps, Hkv, hd) pool, so consecutive
// slots of one head are Hkv*hd elements apart and a tile of 64 keys spans
// several pages.
//   * bf16 queries over a bf16 or int8 pool (the main path, both walks):
//     tensor-core products from a cp.async three-stage ring
//     (flash_common.cuh).  An int8 pool is staged as codes and dequantized
//     on the way to the fragments (code x the fp32 scale[page, h], rounded
//     to bf16: the scale may change inside a tile).
//   * fp32 queries, or a float pool with scales, or head_dim above 128:
//     CUDA-core fp32 products (attention_common.cuh's attend_tile, no
//     TF32) in the same split grid, K/V widened to fp32 in shared memory.
//
// Unreserved pages and empty slots.  The reference reads the trash page
// for a -1 table entry; every slot of such a page carries key_pos == -1, so
// the mask rejects it.  These kernels instead SKIP every slot whose table
// entry is -1 or whose key_pos is negative: they load nothing there (the
// async copy zero-fills) and mark the slot invalid.  Given that invariant
// the result is exact, and the walk moves only the bytes of filled slots.
// A float pool passes no scales (null pointers): its multiply is by 1.0,
// which is exact.
//
// Bound on an H100.  Bytes bound the work: the filled slots' K and V at
// the pool's element size (int8 halves bf16's bytes), plus q, the tree KVs
// and the output (B3: the fp32 partials); the G*W*(S+W)*hd*4 flops are far
// below the tensor-core ridge (bf16: ~38 MB, ~11 us at 3.35 TB/s; int8
// ~6 us).  The split grid fills the card's resident block slots once (256
// blocks at the main path's B*Hkv = 128: two splits), and the async ring
// keeps two tiles in flight per block while one computes.  The cache-only
// walk's carry fold reads n_split partials of B*W*Hq*(hd + 2) floats
// through L2 (1 MB at the main path).
#include "attention_common.cuh"
#include "flash_common.cuh"

#include <type_traits>

namespace {

using namespace attn;

template <typename TQ, typename TP>
struct Args {
  const TQ* q;          // (B, W, Hq, hd)
  const TP* pk;         // (P, ps, Hkv, hd) one layer's pool, trash last
  const TP* pv;
  const float* sk;      // (P, Hkv) dequant scales, or null (float pool)
  const float* sv;
  const TQ* kn;         // (B, W, Hkv, hd) tree KVs (fused only)
  const TQ* vn;
  const int* table;     // (B, maxp), -1 = unreserved
  const int* key_pos;   // (B, maxp * ps)
  const int* q_pos;     // (B, W)
  const int* lo;        // (B, W)
  const uint8_t* mask;  // (W, W) bool (fused only)
  float* o;             // (parts, B, W, Hq, hd) the walk's partials: the
  float* m;             // (parts, B, Hq, W)     workspace, or the caller's
  float* l;             // (parts, B, Hq, W)     o, m, l (cache-only, 1 part)
  int B, W, Hq, Hkv, hd, ps, maxp, tile, rows, nsplit, split_len, parts;
  float scale;
};

// The CUDA-core walk: block z of the fused walk takes slot range z - 1
// (z == 0: the tree), block z of the cache-only walk slot range z; each
// writes part z.
template <typename TQ, typename TP, bool TREE>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(Args<TQ, TP> a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int W = a.W, hd = a.hd, TS = a.tile, ps = a.ps;
  const int G = a.Hq / a.Hkv;
  const int GW = G * W;
  const int S = a.maxp * ps;
  const int tid = threadIdx.x;
  const Smem s = carve(smem, GW, a.rows, W, hd, TS);

  load_queries(s, a.q, b, h, W, a.Hq, G, hd);
  for (int w = tid; w < W; w += kThreads) {
    s.qpos[w] = a.q_pos[b * W + w];
    s.lo[w] = a.lo[b * W + w];
  }
  if (TREE)
    for (int i = tid; i < W * W; i += kThreads) s.mask[i] = a.mask[i];
  __syncthreads();

  constexpr int VP = Vec<TP>::N;
  const int nvec = hd / VP, kstride = hd + 1;
  const int z = blockIdx.z;
  const int split = TREE ? z - 1 : z;
  const int jb = split < 0 ? S : split * a.split_len;
  const int je = split < 0 ? S : min(S, jb + a.split_len);
  for (int j0 = jb; j0 < je; j0 += TS) {
    // ---- per-slot metadata: key position, pool slot, page scales
    for (int t = tid; t < TS; t += kThreads) {
      const int j = j0 + t;
      int kp = -1, phys = -1;
      float ksc = 1.f, vsc = 1.f;
      if (j < je) {
        const int page = a.table[b * a.maxp + j / ps];
        kp = a.key_pos[(size_t)b * S + j];
        if (page >= 0 && kp >= 0) {
          phys = page * ps + j % ps;
          if (a.sk != nullptr) {
            ksc = a.sk[page * a.Hkv + h];
            vsc = a.sv[page * a.Hkv + h];
          }
        } else {
          kp = -1;
        }
      }
      s.kp[t] = kp;
      s.phys[t] = phys;
      s.kscale[t] = ksc;
      s.vscale[t] = vsc;
    }
    __syncthreads();

    // ---- K/V tile, dequantized in registers; skipped slots are zero
    for (int i = tid; i < TS * nvec; i += kThreads) {
      const int t = i / nvec, c = (i % nvec) * VP;
      const int phys = s.phys[t];
      float kf[VP], vf[VP];
      if (phys >= 0) {
        const size_t off = ((size_t)phys * a.Hkv + h) * hd + c;
        load_vec(a.pk + off, kf);
        load_vec(a.pv + off, vf);
        const float ksc = s.kscale[t], vsc = s.vscale[t];
#pragma unroll
        for (int e = 0; e < VP; ++e) {
          kf[e] *= ksc;
          vf[e] *= vsc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VP; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VP; ++e) {
        s.k[t * kstride + c + e] = kf[e];
        s.v[t * hd + c + e] = vf[e];
      }
    }
    // ---- validity: filled, causal, inside the window
    for (int i = tid; i < s.nr * TS; i += kThreads) {
      const int t = i % TS, w = (s.r0 + i / TS) % W;
      const int kp = s.kp[t];
      s.ok[i] = kp >= 0 && kp <= s.qpos[w] && kp > s.lo[w];
    }
    __syncthreads();
    attend_tile(s, TS, hd, a.scale);
  }

  if (TREE && z == 0)
    attend_tree(s, a.kn, a.vn, b, h, W, a.Hkv, hd, TS, a.scale);
  const size_t n_o = (size_t)a.B * W * a.Hq * hd;
  const size_t n_m = (size_t)a.B * a.Hq * W;
  store_partials(s, a.o + z * n_o, a.m + z * n_m, a.l + z * n_m, b, h, W,
                 a.Hq, G, hd);
}

// The fused walk on the tensor cores: bf16 q over a bf16 or int8 pool.
template <typename TP>
__global__ void __launch_bounds__(flash::kThreads)
    paged_flash_kernel(Args<__nv_bfloat16, TP> a) {
  extern __shared__ __align__(16) char fsmem[];
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const flash::PagedSlots<TP> cache{a.pk,    a.pv,      a.sk, a.sv,
                                    a.table, a.key_pos, b,    h,
                                    a.ps,    a.maxp,    a.Hkv, a.hd};
  const flash::TreeSlots tree{a.kn, a.vn, a.mask, b, h, a.W, a.Hkv, a.hd};
  flash::split_block(fsmem, cache, tree, a.q, a.q_pos, a.lo, a.o, a.m, a.l,
                     a.B, a.Hq, a.maxp * a.ps, a.nsplit, a.split_len,
                     a.parts, a.scale);
}

// The cache-only walk on the tensor cores (B3): the same walk and staging,
// no tree, split z into part z.
template <typename TP>
__global__ void __launch_bounds__(flash::kThreads)
    cache_flash_kernel(Args<__nv_bfloat16, TP> a) {
  extern __shared__ __align__(16) char fsmem[];
  const flash::Block k =
      flash::make_block(a.Hkv, a.W, a.Hq, a.hd, flash::kRows, a.scale);
  const flash::PagedSlots<TP> cache{a.pk,    a.pv,      a.sk, a.sv,
                                    a.table, a.key_pos, k.b,  k.h,
                                    a.ps,    a.maxp,    a.Hkv, a.hd};
  flash::cache_block(fsmem, cache, k, a.q, a.q_pos, a.lo, a.o, a.m, a.l,
                     a.B, a.maxp * a.ps, a.split_len);
}

// out: the fused walk's output; o, m, l: the cache-only walk's; ws_*: the
// split partials (null when the cache-only walk has one split).
struct Ptrs {
  const void *q, *pk, *pv, *sk, *sv, *kn, *vn, *table, *key_pos, *q_pos, *lo,
      *mask;
  void *out, *o, *m, *l, *ws_o, *ws_m, *ws_l;
};

// The tensor-core route: bf16 queries over a bf16 pool without scales or
// an int8 pool, head_dim within the register tiles (a float pool with
// scales is dequantized in fp32 by the CUDA cores).  kernels/launch.py::
// flash_route states the same rule.
template <typename TQ, typename TP>
constexpr bool kFlashTypes = std::is_same<TQ, __nv_bfloat16>::value &&
                             !std::is_same<TP, float>::value;
template <typename TQ, typename TP>
bool use_flash(int hd, bool scaled) {
  return kFlashTypes<TQ, TP> && hd <= flash::kHdMax &&
         (std::is_same<TP, int8_t>::value || !scaled);
}

template <typename TQ, typename TP, bool TREE>
int run(const Ptrs& p, int B, int W, int Hq, int Hkv, int hd, int ps,
        int maxp, int tile, int rows, int nsplit, int split_len, int parts,
        float scale, cudaStream_t stream) {
  const bool tc = use_flash<TQ, TP>(hd, p.sk != nullptr);
  // parts: the fused walk's tree is a part of its own unless the
  // tensor-core walk folds a tree of one tile into the last split; the
  // cache-only walk has none
  const int want = !TREE ? nsplit : nsplit + (tc ? W > flash::kTile : 1);
  if (nsplit < 1 || parts != want ||
      (!TREE && nsplit > 1 && p.ws_o == nullptr))
    return (int)cudaErrorInvalidValue;
  // the walk's destination: the workspace, or with one cache-only split
  // the caller's partials
  const bool direct = !TREE && nsplit == 1;
  Args<TQ, TP> a;
  a.q = static_cast<const TQ*>(p.q);
  a.pk = static_cast<const TP*>(p.pk);
  a.pv = static_cast<const TP*>(p.pv);
  a.sk = static_cast<const float*>(p.sk);
  a.sv = static_cast<const float*>(p.sv);
  a.kn = static_cast<const TQ*>(p.kn);
  a.vn = static_cast<const TQ*>(p.vn);
  a.table = static_cast<const int*>(p.table);
  a.key_pos = static_cast<const int*>(p.key_pos);
  a.q_pos = static_cast<const int*>(p.q_pos);
  a.lo = static_cast<const int*>(p.lo);
  a.mask = static_cast<const uint8_t*>(p.mask);
  a.o = static_cast<float*>(direct ? p.o : p.ws_o);
  a.m = static_cast<float*>(direct ? p.m : p.ws_m);
  a.l = static_cast<float*>(direct ? p.l : p.ws_l);
  a.B = B;
  a.W = W;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.ps = ps;
  a.maxp = maxp;
  a.tile = tile;
  a.rows = rows;
  a.nsplit = nsplit;
  a.split_len = split_len;
  a.parts = parts;
  a.scale = scale;
  const int GW = Hq / Hkv * W;
  cudaError_t err;
  if (tc) {
    if constexpr (kFlashTypes<TQ, TP>) {
      if (tile != flash::kTile || rows != flash::kRows)
        return (int)cudaErrorInvalidValue;
      auto kernel = TREE ? &paged_flash_kernel<TP> : &cache_flash_kernel<TP>;
      static SmemAttr attr;
      const size_t smem = flash::layout(hd).total;
      err = raise_smem(reinterpret_cast<const void*>(kernel), attr);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(B * Hkv, (GW + flash::kRows - 1) / flash::kRows,
                      parts);
      kernel<<<grid, flash::kThreads, smem, stream>>>(a);
    }
  } else {
    static SmemAttr attr;
    const size_t smem = smem_bytes(rows, W, hd, tile);
    err = raise_smem(
        reinterpret_cast<const void*>(paged_attention_kernel<TQ, TP, TREE>),
        attr);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * Hkv, (GW + rows - 1) / rows, parts);
    paged_attention_kernel<TQ, TP, TREE><<<grid, kThreads, smem, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const int threads = B * W * Hq * (hd / 4);
  const int blocks = (threads + 127) / 128;
  if (TREE)
    flash::merge_kernel<TQ><<<blocks, 128, 0, stream>>>(
        a.o, a.m, a.l, parts, static_cast<TQ*>(p.out), B, W, Hq, hd);
  else
    flash::carry_fold_kernel<<<blocks, 128, 0, stream>>>(
        a.o, a.m, a.l, parts, static_cast<float*>(p.o),
        static_cast<float*>(p.m), static_cast<float*>(p.l), B, W, Hq, hd);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = fp32, 1 = bf16, 2 = int8 (pool only)
template <typename TQ, bool TREE>
int by_pool(int pool_dtype, const Ptrs& p, int B, int W, int Hq, int Hkv,
            int hd, int ps, int maxp, int tile, int rows, int nsplit,
            int split_len, int parts, float scale, cudaStream_t st) {
  switch (pool_dtype) {
    case 0:
      return run<TQ, float, TREE>(p, B, W, Hq, Hkv, hd, ps, maxp, tile, rows,
                                  nsplit, split_len, parts, scale, st);
    case 1:
      return run<TQ, __nv_bfloat16, TREE>(p, B, W, Hq, Hkv, hd, ps, maxp,
                                          tile, rows, nsplit, split_len,
                                          parts, scale, st);
    case 2:
      return run<TQ, int8_t, TREE>(p, B, W, Hq, Hkv, hd, ps, maxp, tile,
                                   rows, nsplit, split_len, parts, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool TREE>
int by_q(int q_dtype, int pool_dtype, const Ptrs& p, int B, int W, int Hq,
         int Hkv, int hd, int ps, int maxp, int tile, int rows, int nsplit,
         int split_len, int parts, float scale, cudaStream_t st) {
  switch (q_dtype) {
    case 0:
      return by_pool<float, TREE>(pool_dtype, p, B, W, Hq, Hkv, hd, ps, maxp,
                                  tile, rows, nsplit, split_len, parts,
                                  scale, st);
    case 1:
      return by_pool<__nv_bfloat16, TREE>(pool_dtype, p, B, W, Hq, Hkv, hd,
                                          ps, maxp, tile, rows, nsplit,
                                          split_len, parts, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of a tensor-core walk (bf16 pool) resident on one SM; `attr` is
// the kernel's own record of its raised shared-memory attribute.
template <typename K>
int blocks_per_sm(K kernel, SmemAttr& attr, int hd) {
  const int smem = (int)flash::layout(hd).total;
  int n = 0;
  if (raise_smem(reinterpret_cast<const void*>(kernel), attr) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, flash::kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

size_t paged_attention_smem_bytes(int rows, int W, int hd, int tile) {
  return attn::smem_bytes(rows, W, hd, tile);
}

// Shared memory of a tensor-core block (flash_common.cuh's layout; both
// walks).
size_t paged_attention_flash_smem_bytes(int hd) {
  return flash::layout(hd).total;
}

// Blocks of the fused tensor-core walk resident on one SM (the occupancy
// query; kernels/launch.py::split_plan sizes the split with it).
int paged_attention_flash_blocks_per_sm(int hd) {
  static attn::SmemAttr attr;
  return blocks_per_sm(paged_flash_kernel<__nv_bfloat16>, attr, hd);
}

// The same for the cache-only tensor-core walk.
int paged_cache_flash_blocks_per_sm(int hd) {
  static attn::SmemAttr attr;
  return blocks_per_sm(cache_flash_kernel<__nv_bfloat16>, attr, hd);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused page walk + tree tile (paged_tree_attention): the split walk into
// the workspace ws_o (parts, B, W, Hq, hd), ws_m, ws_l (parts, B, Hq, W),
// then the merge into `out`; two launches.  `tile` and `rows` are kTile
// and kRows on the tensor-core path; parts is n_split + 1 (n_split on the
// tensor-core path when W <= kTile: the last split walks the tree).
int paged_tree_attention(int q_dtype, int pool_dtype, const void* q,
                         const void* pk, const void* pv, const void* sk,
                         const void* sv, const void* kn, const void* vn,
                         const void* table, const void* key_pos,
                         const void* q_pos, const void* lo, const void* mask,
                         void* out, void* ws_o, void* ws_m, void* ws_l, int B,
                         int W, int Hq, int Hkv, int hd, int ps, int maxp,
                         int tile, int rows, int nsplit, int split_len,
                         int parts, float scale, void* stream) {
  Ptrs p{q,   pk,      pv,      sk,      sv,   kn,   vn,   table,
         key_pos, q_pos, lo,   mask, out,  nullptr, nullptr, nullptr,
         ws_o, ws_m, ws_l};
  return by_q<true>(q_dtype, pool_dtype, p, B, W, Hq, Hkv, hd, ps, maxp, tile,
                    rows, nsplit, split_len, parts, scale,
                    static_cast<cudaStream_t>(stream));
}

// Cache-only page walk (paged_cache_attention): the partials o, m, l.  With
// n_split == 1 (parts == 1) the walk writes them directly and ws_* may be
// null; else it writes the workspace and the carry fold folds it into
// o, m, l; two launches.
int paged_cache_attention(int q_dtype, int pool_dtype, const void* q,
                          const void* pk, const void* pv, const void* sk,
                          const void* sv, const void* table,
                          const void* key_pos, const void* q_pos,
                          const void* lo, void* o, void* m, void* l,
                          void* ws_o, void* ws_m, void* ws_l, int B, int W,
                          int Hq, int Hkv, int hd, int ps, int maxp, int tile,
                          int rows, int nsplit, int split_len, int parts,
                          float scale, void* stream) {
  Ptrs p{q,       pk,    pv, sk,      sv, nullptr, nullptr, table,
         key_pos, q_pos, lo, nullptr, nullptr, o, m, l, ws_o, ws_m, ws_l};
  return by_q<false>(q_dtype, pool_dtype, p, B, W, Hq, Hkv, hd, ps, maxp,
                     tile, rows, nsplit, split_len, parts, scale,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
