// Device pieces shared by the dense verify (verify_attention.cu), the paged
// page walk (paged_attention.cu) and the sparse tree kernels
// (tree_partial.cu): vector loads that widen to fp32, warp reductions, the
// shared-memory layout of one block, the masked online-softmax update of
// one key tile, the tree tiles and the two epilogues.
//
// A block owns one (batch row b, kv head h) and one tile of its G*W query
// rows (query head h*G + g, row r = g*W + w: the reference's GQA grouping).
// The grid is (B*Hkv, ceil(G*W / R)): blockIdx.y picks rows
// [y*R, min((y+1)*R, G*W)), so a long piece (a W=256 chunked-prefill chain)
// or a wide GQA group fits a block's shared memory; each row's softmax is
// independent, so the result does not depend on R.  The rows sit in shared
// memory in fp32 beside their o, m, l accumulators.  A caller stages a tile
// of keys (K with rows padded to hd + 1 floats, so the q.k reads of
// neighbouring threads hit distinct banks; V unpadded) and the (row, key)
// validity flags, then calls attend_tile.  Scores outside the mask are the
// finite kNegInf and their probabilities exactly 0 (a valid flag, never a
// comparison with -inf), so no (-inf) - (-inf) NaN can arise and an
// all-masked row keeps l = 0, m = kNegInf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements per 16-byte vector load: 4 fp32, 8 bf16, 16 int8
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_f32(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block; R = the rows a block holds.
struct Smem {
  float* q;       // (R, hd) query rows
  float* o;       // (R, hd) output accumulator
  float* k;       // (tile, hd + 1) K tile, fp32 (dequantized)
  float* v;       // (tile, hd) V tile
  float* p;       // (R, tile) scores, then probabilities
  float* m;       // (R) running max
  float* l;       // (R) running sum
  float* corr;    // (R) rescale of this tile
  float* kscale;  // (tile) per-slot K dequant scale
  float* vscale;  // (tile) per-slot V dequant scale
  int* kp;        // (tile) key position per slot, -1 = not read
  int* phys;      // (tile) pool slot per slot, -1 = not read
  int* qpos;      // (W)
  int* lo;        // (W)
  uint8_t* mask;  // (W, W) tree mask
  uint8_t* ok;    // (R, tile) validity of (row, key)
  int r0;         // first query row of this block's tile
  int nr;         // query rows of this block (<= R; fewer in the last tile)
};

// Bytes of shared memory a block of R query rows needs.
__host__ __device__ inline size_t smem_bytes(int R, int W, int hd,
                                             int tile) {
  const size_t floats = 2 * (size_t)R * hd + (size_t)tile * (hd + 1) +
                        (size_t)tile * hd + (size_t)R * tile +
                        3 * (size_t)R + 2 * (size_t)tile;
  const size_t ints = 2 * (size_t)tile + 2 * (size_t)W;
  const size_t bytes = (size_t)W * W + (size_t)R * tile;
  return floats * 4 + ints * 4 + bytes;
}

// Lay out one block's shared memory for R rows, and place the block on its
// row tile: rows [blockIdx.y * R, min(blockIdx.y * R + R, GW)).
__device__ inline Smem carve(float* base, int GW, int R, int W, int hd,
                             int tile) {
  Smem s;
  s.r0 = blockIdx.y * R;
  s.nr = min(R, GW - s.r0);
  s.q = base;
  s.o = s.q + R * hd;
  s.k = s.o + R * hd;
  s.v = s.k + tile * (hd + 1);
  s.p = s.v + tile * hd;
  s.m = s.p + R * tile;
  s.l = s.m + R;
  s.corr = s.l + R;
  s.kscale = s.corr + R;
  s.vscale = s.kscale + tile;
  s.kp = reinterpret_cast<int*>(s.vscale + tile);
  s.phys = s.kp + tile;
  s.qpos = s.phys + tile;
  s.lo = s.qpos + W;
  s.mask = reinterpret_cast<uint8_t*>(s.lo + W);
  s.ok = s.mask + W * W;
  return s;
}

// The block's query rows, local row i = global row r = r0 + i = g*W + w
// <- q[b, w, h*G + g, :]; o = 0, m = kNegInf, l = 0.
template <typename TQ>
__device__ void load_queries(const Smem& s, const TQ* q, int b, int h, int W,
                             int Hq, int G, int hd) {
  constexpr int VN = Vec<TQ>::N;
  const int nvec = hd / VN;
  for (int i = threadIdx.x; i < s.nr * nvec; i += kThreads) {
    const int lr = i / nvec, c = (i % nvec) * VN;
    const int r = s.r0 + lr, g = r / W, w = r % W;
    load_vec(q + ((size_t)(b * W + w) * Hq + h * G + g) * hd + c,
             s.q + lr * hd + c);
  }
  for (int i = threadIdx.x; i < s.nr * hd; i += kThreads) s.o[i] = 0.f;
  for (int r = threadIdx.x; r < s.nr; r += kThreads) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
  }
}

// One staged tile: masked scores, the online-softmax update (one warp per
// query row), then o = o * corr + p @ V.  Ends with a barrier, so the
// caller may stage the next tile right away.
__device__ inline void attend_tile(const Smem& s, int tile, int hd,
                                   float scale) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nr = s.nr;
  const int kstride = hd + 1;
  for (int i = tid; i < nr * tile; i += kThreads) {
    const int r = i / tile, t = i % tile;
    float sc = kNegInf;
    if (s.ok[i]) {
      const float* qr = s.q + r * hd;
      const float* kr = s.k + t * kstride;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
      sc = acc * scale;
    }
    s.p[i] = sc;
  }
  __syncthreads();

  for (int r = warp; r < nr; r += kWarps) {
    float* pr = s.p + r * tile;
    const uint8_t* okr = s.ok + r * tile;
    float mx = kNegInf;
    for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_old = s.m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < tile; t += 32) {
      const float e = okr[t] ? expf(pr[t] - m_new) : 0.f;
      pr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      s.corr[r] = c;
      s.l[r] = s.l[r] * c + sum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();

  for (int i = tid; i < nr * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const float* pr = s.p + r * tile;
    float acc = s.o[i] * s.corr[r];
    for (int t = 0; t < tile; ++t) acc = fmaf(pr[t], s.v[t * hd + d], acc);
    s.o[i] = acc;
  }
  __syncthreads();
}

// The W fresh tree KVs (B, W, Hkv, hd) under the W x W ancestor mask (in
// s.mask), in tiles of at most `tile` keys, cut to W rounded up to 8 so a
// small tree does not pay for a full cache-sized tile; keys past W are zero
// and invalid.
template <typename TQ>
__device__ void attend_tree(const Smem& s, const TQ* kn, const TQ* vn, int b,
                            int h, int W, int Hkv, int hd, int tile,
                            float scale) {
  tile = min(tile, (W + 7) / 8 * 8);
  constexpr int VN = Vec<TQ>::N;
  const int nvec = hd / VN, kstride = hd + 1;
  for (int j0 = 0; j0 < W; j0 += tile) {
    for (int i = threadIdx.x; i < tile * nvec; i += kThreads) {
      const int t = i / nvec, c = (i % nvec) * VN, j = j0 + t;
      float kf[VN], vf[VN];
      if (j < W) {
        const size_t off = ((size_t)(b * W + j) * Hkv + h) * hd + c;
        load_vec(kn + off, kf);
        load_vec(vn + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        s.k[t * kstride + c + e] = kf[e];
        s.v[t * hd + c + e] = vf[e];
      }
    }
    for (int i = threadIdx.x; i < s.nr * tile; i += kThreads) {
      const int t = i % tile, w = (s.r0 + i / tile) % W, j = j0 + t;
      s.ok[i] = j < W && s.mask[w * W + j];
    }
    __syncthreads();
    attend_tile(s, tile, hd, scale);
  }
}

// o / max(l, 1e-30) in q's layout (B, W, Hq, hd) and dtype.
template <typename TQ>
__device__ void store_normalized(const Smem& s, TQ* out, int b, int h, int W,
                                 int Hq, int G, int hd) {
  for (int i = threadIdx.x; i < s.nr * hd; i += kThreads) {
    const int lr = i / hd, d = i % hd;
    const int r = s.r0 + lr, g = r / W, w = r % W;
    const float inv = 1.0f / fmaxf(s.l[lr], 1e-30f);
    out[((size_t)(b * W + w) * Hq + h * G + g) * hd + d] =
        from_f32<TQ>(s.o[i] * inv);
  }
}

// Unnormalized partials in the merge layout: o (B, W, Hq, hd) fp32 and
// m, l (B, Hq, W); m is clamped to at least kNegInf / 2 (the reference's
// m_safe), so an all-masked row reads l = 0, m = -5e29.
__device__ inline void store_partials(const Smem& s, float* o, float* m,
                                      float* l, int b, int h, int W, int Hq,
                                      int G, int hd) {
  for (int i = threadIdx.x; i < s.nr * hd; i += kThreads) {
    const int r = s.r0 + i / hd, d = i % hd;
    const int g = r / W, w = r % W;
    o[((size_t)(b * W + w) * Hq + h * G + g) * hd + d] = s.o[i];
  }
  for (int lr = threadIdx.x; lr < s.nr; lr += kThreads) {
    const int r = s.r0 + lr, g = r / W, w = r % W;
    const size_t idx = ((size_t)b * Hq + h * G + g) * W + w;
    m[idx] = fmaxf(s.m[lr], kNegInf * 0.5f);
    l[idx] = s.l[lr];
  }
}

// ---------------------------------------------------------------- host
// The dynamic shared memory a kernel instance may use, raised with
// cudaFuncSetAttribute once per instance and device, to the most the device
// lets a block opt into less the instance's static shared memory: `attr`
// (one static per instance) records that it was done on each device, and a
// later launch sets nothing.  The value is the same on every call, so two
// threads that both set it leave the same attribute in either order; a
// launch asking for more than the device allows fails at the launch.  The
// attribute is a cap, not a reservation: a launch still occupies only the
// shared memory it asks for.
constexpr int kMaxDevices = 16;

struct SmemAttr {
  std::atomic<bool> set[kMaxDevices] = {};
};

inline cudaError_t raise_smem(const void* kernel, SmemAttr& attr) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && attr.set[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin - static_cast<int>(fa.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices)
    attr.set[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace attn
