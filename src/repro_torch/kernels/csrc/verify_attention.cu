// Fused tree-verification attention over the dense per-row KV ring cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tree_attention.py::
// tree_attention (body `_kernel`).  It computes exactly
// src/repro_torch/kernels/plain.py::tree_attention_plain: the W draft
// queries of a row attend to
//   * the cache slots s with key_pos >= 0, key_pos <= q_pos and
//     key_pos > lo (validity, causality, sliding window), then
//   * the W fresh tree KVs under the W x W ancestor-or-self mask,
// under ONE fp32 online softmax (o, m, l); the output is o / max(l, 1e-30)
// cast to q's dtype.  Scores outside the mask are set to the finite
// NEG_INF and their probabilities to exactly 0, so no (-inf) - (-inf) NaN
// can arise; a row that sees no valid cache slot keeps m = NEG_INF until
// the tree part (which always holds the node itself) arrives.
//
// Design.  One thread block per (batch row b, kv head h).  The G*W query
// rows that read kv head h (query head h*G + g, row r = g*W + w, the
// reference's grouping) sit in shared memory in fp32 with their o, m and l
// accumulators.  A loop inside the block walks the S + W keys in tiles of
// `tile`: key j < S is cache slot j, key j >= S is tree node j - S, so the
// tree block is simply the last tile(s) of the same walk.  That loop takes
// the place of the TPU kernel's sequential grid axis.  Per tile: 16-byte
// vector loads of K and V into shared memory (converted to fp32), scores
// q.k on the CUDA cores, a warp-per-row online-softmax update, then
// o = o * corr + p @ V.  The ragged cache edge is masked here, never padded
// by the caller.
//
// Bound on an H100.  The work is bytes-bound: the cache K and V of the row,
// read once, dominate (at the main path's vicuna-7b shape, B=4, S~600,
// Hkv=32, hd=128, bf16: ~38 MB per launch, ~11 us at 3.35 TB/s), while the
// G*W*(S+W)*hd*4 flops are far below the tensor-core ridge.  The design
// reads every cache byte exactly once (no re-reads across query rows: the
// G*W rows share each K/V tile) and keeps everything else on chip.  It does
// not yet split over S: with B*Hkv blocks (128 at the main path) each SM
// walks its whole row with synchronous loads, so it is latency-bound well
// above the byte bound.  A split-KV pass with an Eq.-1 merge, cp.async/TMA
// double buffering and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// elements per 16-byte vector load
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
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
struct Args {
  const T* q;             // (B, W, Hq, hd)
  const T* ck;            // (B, S, Hkv, hd)
  const T* cv;            // (B, S, Hkv, hd)
  const T* kn;            // (B, W, Hkv, hd)
  const T* vn;            // (B, W, Hkv, hd)
  const int* key_pos;     // (B, S)
  const int* q_pos;       // (B, W)
  const int* lo;          // (B, W)
  const uint8_t* mask;    // (W, W) bool
  T* out;                 // (B, W, Hq, hd)
  int B, W, Hq, Hkv, hd, S, tile;
  float scale;
};

// Shared memory of one block, in bytes (the host sizes the launch with it).
size_t smem_bytes(int G, int W, int hd, int tile) {
  const size_t GW = (size_t)G * W;
  const size_t floats = 2 * GW * hd              // q rows, o accumulator
                        + (size_t)tile * (hd + 1)  // K tile (padded rows)
                        + (size_t)tile * hd        // V tile
                        + GW * tile                // scores / probabilities
                        + 3 * GW;                  // m, l, correction
  const size_t ints = (size_t)tile + 2 * W;        // key_pos tile, q_pos, lo
  const size_t bytes = (size_t)W * W + GW * tile;  // tree mask, valid flags
  return floats * 4 + ints * 4 + bytes;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) verify_attention_kernel(Args<T> a) {
  extern __shared__ float smem[];
  constexpr int VN = Vec<T>::N;
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int W = a.W, hd = a.hd, S = a.S, TS = a.tile;
  const int G = a.Hq / a.Hkv;
  const int GW = G * W;
  const int kstride = hd + 1;  // padded K rows: conflict-free q.k reads
  const int nvec = hd / VN;
  const int total = S + W;
  const int tid = threadIdx.x;

  float* sq = smem;
  float* so = sq + GW * hd;
  float* sk = so + GW * hd;
  float* sv = sk + TS * kstride;
  float* sp = sv + TS * hd;
  float* sm = sp + GW * TS;
  float* sl = sm + GW;
  float* sc = sl + GW;
  int* skp = reinterpret_cast<int*>(sc + GW);
  int* sqp = skp + TS;
  int* slo = sqp + W;
  uint8_t* smask = reinterpret_cast<uint8_t*>(slo + W);
  uint8_t* sok = smask + W * W;

  // query rows r = g*W + w <- q[b, w, h*G + g, :]
  for (int i = tid; i < GW * nvec; i += kThreads) {
    const int r = i / nvec, c = (i % nvec) * VN;
    const int g = r / W, w = r % W;
    load_vec(a.q + ((size_t)(b * W + w) * a.Hq + h * G + g) * hd + c,
             sq + r * hd + c);
  }
  for (int i = tid; i < GW * hd; i += kThreads) so[i] = 0.f;
  for (int r = tid; r < GW; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  for (int w = tid; w < W; w += kThreads) {
    sqp[w] = a.q_pos[b * W + w];
    slo[w] = a.lo[b * W + w];
  }
  for (int i = tid; i < W * W; i += kThreads) smask[i] = a.mask[i];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;

  for (int j0 = 0; j0 < total; j0 += TS) {
    // ---- K/V tile: cache slots first, then the tree nodes, zero past end
    for (int i = tid; i < TS * nvec; i += kThreads) {
      const int t = i / nvec, c = (i % nvec) * VN;
      const int j = j0 + t;
      float kf[VN], vf[VN];
      if (j < S) {
        const size_t off = ((size_t)(b * S + j) * a.Hkv + h) * hd + c;
        load_vec(a.ck + off, kf);
        load_vec(a.cv + off, vf);
      } else if (j < total) {
        const size_t off = ((size_t)(b * W + (j - S)) * a.Hkv + h) * hd + c;
        load_vec(a.kn + off, kf);
        load_vec(a.vn + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        sk[t * kstride + c + e] = kf[e];
        sv[t * hd + c + e] = vf[e];
      }
    }
    for (int t = tid; t < TS; t += kThreads) {
      const int j = j0 + t;
      skp[t] = j < S ? a.key_pos[(size_t)b * S + j] : -1;
    }
    __syncthreads();

    // ---- masked scores
    for (int i = tid; i < GW * TS; i += kThreads) {
      const int r = i / TS, t = i % TS;
      const int w = r % W, j = j0 + t;
      bool ok;
      if (j < S) {
        const int kp = skp[t];
        ok = kp >= 0 && kp <= sqp[w] && kp > slo[w];
      } else if (j < total) {
        ok = smask[w * W + (j - S)] != 0;
      } else {
        ok = false;
      }
      float s = kNegInf;
      if (ok) {
        const float* qr = sq + r * hd;
        const float* kr = sk + t * kstride;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc * a.scale;
      }
      sp[i] = s;
      sok[i] = ok;
    }
    __syncthreads();

    // ---- online-softmax update, one warp per query row
    for (int r = warp; r < GW; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, sp[r * TS + t]);
      mx = warp_max(mx);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        const float p = sok[r * TS + t] ? expf(sp[r * TS + t] - m_new) : 0.f;
        sp[r * TS + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[r] = corr;
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // ---- o = o * corr + p @ V
    for (int i = tid; i < GW * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = sp + r * TS;
      float acc = so[i] * sc[r];
      for (int t = 0; t < TS; ++t) acc = fmaf(pr[t], sv[t * hd + d], acc);
      so[i] = acc;
    }
    __syncthreads();
  }

  // ---- normalize and store in q's layout
  for (int i = tid; i < GW * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int g = r / W, w = r % W;
    const float inv = 1.0f / fmaxf(sl[r], 1e-30f);
    a.out[((size_t)(b * W + w) * a.Hq + h * G + g) * hd + d] =
        from_f32<T>(so[i] * inv);
  }
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Hq / a.Hkv, a.W, a.hd, a.tile);
  cudaError_t err = cudaFuncSetAttribute(
      verify_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  verify_attention_kernel<T><<<a.B * a.Hkv, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* ck, const void* cv, const void* kn,
        const void* vn, const void* key_pos, const void* q_pos,
        const void* lo, const void* mask, void* out, int B, int W, int Hq,
        int Hkv, int hd, int S, int tile, float scale, void* stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.ck = static_cast<const T*>(ck);
  a.cv = static_cast<const T*>(cv);
  a.kn = static_cast<const T*>(kn);
  a.vn = static_cast<const T*>(vn);
  a.key_pos = static_cast<const int*>(key_pos);
  a.q_pos = static_cast<const int*>(q_pos);
  a.lo = static_cast<const int*>(lo);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.W = W;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.S = S;
  a.tile = tile;
  a.scale = scale;
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

size_t verify_attention_smem_bytes(int G, int W, int hd, int tile) {
  return smem_bytes(G, W, hd, tile);
}

const char* verify_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int verify_attention_f32(const void* q, const void* ck, const void* cv,
                         const void* kn, const void* vn, const void* key_pos,
                         const void* q_pos, const void* lo, const void* mask,
                         void* out, int B, int W, int Hq, int Hkv, int hd,
                         int S, int tile, float scale, void* stream) {
  return run<float>(q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out, B, W,
                    Hq, Hkv, hd, S, tile, scale, stream);
}

int verify_attention_bf16(const void* q, const void* ck, const void* cv,
                          const void* kn, const void* vn, const void* key_pos,
                          const void* q_pos, const void* lo, const void* mask,
                          void* out, int B, int W, int Hq, int Hkv, int hd,
                          int S, int tile, float scale, void* stream) {
  return run<__nv_bfloat16>(q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out,
                            B, W, Hq, Hkv, hd, S, tile, scale, stream);
}

}  // extern "C"
