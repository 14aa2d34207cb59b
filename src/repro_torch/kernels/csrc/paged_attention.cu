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
// The page walk.  The TPU kernel gets the block table by scalar prefetch
// and lets a BlockSpec index map DMA page table[b, i] at grid step i.
// Here there is no prefetch: one thread block per (row b, kv head h, tile
// of query rows) reads its own table.  It walks the logical slots
// j = 0 .. maxp*ps - 1 in tiles of `tile` keys; slot j lives at pool slot
// table[b, j/ps]*ps + j%ps of the (P, ps, Hkv, hd) pool, so consecutive
// slots of one head are Hkv*hd elements apart and a tile of 64 keys spans
// several pages when ps is 4, 8 or 16.  Before each tile the block stages, per slot, its key
// position, its pool slot and its page's (K, V) scales; then it loads K/V
// with 16-byte vectors (16 int8, 8 bf16 or 4 fp32 values), dequantizes in
// registers (fp32 code * scale[page, h]: the scale may change inside a
// tile) and stores fp32 tiles in shared memory.  Everything accumulates in
// fp32 on the CUDA cores (no TF32).
//
// Unreserved pages and empty slots.  The reference reads the trash page
// for a -1 table entry; every slot of such a page carries key_pos == -1, so
// the mask rejects it.  This kernel instead SKIPS every slot whose table
// entry is -1 or whose key_pos is negative: it loads nothing there and
// marks the slot invalid.  Given that invariant the result is exact, and
// the walk moves only the bytes of filled slots.  A float pool passes no
// scales (null pointers): its multiply is by 1.0, which is exact.
//
// Bound on an H100.  Bytes bound the work: the filled slots' K and V at
// the pool's element size (int8 halves bf16's bytes), plus q, the tree KVs
// and the output; the G*W*(S+W)*hd*4 flops are far below the tensor-core
// ridge.  Like verify_attention.cu, the design reads every pool byte once
// per row tile (the rows of a tile share each key tile; at the main path
// all G*W rows are one tile) and keeps the rest on chip,
// but it does not split over S: with B*Hkv blocks (128 at the main path)
// and synchronous loads it is latency-bound well above the byte bound.  A
// split-KV grid merged by Eq. 1, cp.async/TMA double buffering and wgmma
// are later work.
#include "attention_common.cuh"

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
  TQ* out;              // (B, W, Hq, hd) normalized (fused)
  float* o;             // (B, W, Hq, hd) unnormalized (cache-only)
  float* m;             // (B, Hq, W) (cache-only)
  float* l;             // (B, Hq, W) (cache-only)
  int B, W, Hq, Hkv, hd, ps, maxp, tile, rows;
  float scale;
};

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
  for (int j0 = 0; j0 < S; j0 += TS) {
    // ---- per-slot metadata: key position, pool slot, page scales
    for (int t = tid; t < TS; t += kThreads) {
      const int j = j0 + t;
      int kp = -1, phys = -1;
      float ksc = 1.f, vsc = 1.f;
      if (j < S) {
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

  if constexpr (TREE) {
    attend_tree(s, a.kn, a.vn, b, h, W, a.Hkv, hd, TS, a.scale);
    store_normalized(s, a.out, b, h, W, a.Hq, G, hd);
  } else {
    store_partials(s, a.o, a.m, a.l, b, h, W, a.Hq, G, hd);
  }
}

struct Ptrs {
  const void *q, *pk, *pv, *sk, *sv, *kn, *vn, *table, *key_pos, *q_pos, *lo,
      *mask;
  void *out, *o, *m, *l;
};

template <typename TQ, typename TP, bool TREE>
int run(const Ptrs& p, int B, int W, int Hq, int Hkv, int hd, int ps,
        int maxp, int tile, int rows, float scale, cudaStream_t stream) {
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
  a.out = static_cast<TQ*>(p.out);
  a.o = static_cast<float*>(p.o);
  a.m = static_cast<float*>(p.m);
  a.l = static_cast<float*>(p.l);
  a.B = B;
  a.W = W;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.ps = ps;
  a.maxp = maxp;
  a.tile = tile;
  a.rows = rows;
  a.scale = scale;
  const size_t smem = smem_bytes(rows, W, hd, tile);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<TQ, TP, TREE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (Hq / Hkv * W + rows - 1) / rows);
  paged_attention_kernel<TQ, TP, TREE><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = fp32, 1 = bf16, 2 = int8 (pool only)
template <typename TQ, bool TREE>
int by_pool(int pool_dtype, const Ptrs& p, int B, int W, int Hq, int Hkv,
            int hd, int ps, int maxp, int tile, int rows, float scale,
            cudaStream_t st) {
  switch (pool_dtype) {
    case 0:
      return run<TQ, float, TREE>(p, B, W, Hq, Hkv, hd, ps, maxp, tile, rows,
                                  scale, st);
    case 1:
      return run<TQ, __nv_bfloat16, TREE>(p, B, W, Hq, Hkv, hd, ps, maxp,
                                          tile, rows, scale, st);
    case 2:
      return run<TQ, int8_t, TREE>(p, B, W, Hq, Hkv, hd, ps, maxp, tile,
                                   rows, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool TREE>
int by_q(int q_dtype, int pool_dtype, const Ptrs& p, int B, int W, int Hq,
         int Hkv, int hd, int ps, int maxp, int tile, int rows, float scale,
         cudaStream_t st) {
  switch (q_dtype) {
    case 0:
      return by_pool<float, TREE>(pool_dtype, p, B, W, Hq, Hkv, hd, ps, maxp,
                                  tile, rows, scale, st);
    case 1:
      return by_pool<__nv_bfloat16, TREE>(pool_dtype, p, B, W, Hq, Hkv, hd,
                                          ps, maxp, tile, rows, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t paged_attention_smem_bytes(int rows, int W, int hd, int tile) {
  return attn::smem_bytes(rows, W, hd, tile);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused page walk + tree tile (paged_tree_attention): writes `out`.
int paged_tree_attention(int q_dtype, int pool_dtype, const void* q,
                         const void* pk, const void* pv, const void* sk,
                         const void* sv, const void* kn, const void* vn,
                         const void* table, const void* key_pos,
                         const void* q_pos, const void* lo, const void* mask,
                         void* out, int B, int W, int Hq, int Hkv, int hd,
                         int ps, int maxp, int tile, int rows, float scale,
                         void* stream) {
  Ptrs p{q, pk, pv, sk, sv, kn, vn, table, key_pos, q_pos, lo, mask,
         out, nullptr, nullptr, nullptr};
  return by_q<true>(q_dtype, pool_dtype, p, B, W, Hq, Hkv, hd, ps, maxp, tile,
                    rows, scale, static_cast<cudaStream_t>(stream));
}

// Cache-only page walk (paged_cache_attention): writes the partials o, m, l.
int paged_cache_attention(int q_dtype, int pool_dtype, const void* q,
                          const void* pk, const void* pv, const void* sk,
                          const void* sv, const void* table,
                          const void* key_pos, const void* q_pos,
                          const void* lo, void* o, void* m, void* l, int B,
                          int W, int Hq, int Hkv, int hd, int ps, int maxp,
                          int tile, int rows, float scale, void* stream) {
  Ptrs p{q, pk, pv, sk, sv, nullptr, nullptr, table, key_pos, q_pos, lo,
         nullptr, nullptr, o, m, l};
  return by_q<false>(q_dtype, pool_dtype, p, B, W, Hq, Hkv, hd, ps, maxp,
                     tile, rows, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
