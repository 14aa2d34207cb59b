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
// Design.  One thread block per (batch row b, kv head h, tile of R query
// rows), with the shared pieces of attention_common.cuh: the query rows
// that read kv head h (query head h*G + g, row r = g*W + w, the reference's
// grouping) sit in shared memory in fp32 with their o, m and l
// accumulators; R covers all G*W rows unless they overflow a block's shared
// memory (a W=256 prefill piece), and then each row tile re-reads the
// row's cache.  A loop inside
// the block walks the S cache slots in tiles of `tile` (16-byte vector
// loads of K and V into shared memory, converted to fp32; empty slots,
// key_pos < 0, are neither loaded nor attended), then the W tree nodes
// (attend_tree); that loop takes the place of the TPU kernel's sequential
// grid axis.  Per tile: scores q.k on the CUDA cores, a warp-per-row
// online-softmax update, then o = o * corr + p @ V.  The ragged cache edge
// is masked here, never padded by the caller.
//
// Bound on an H100.  The work is bytes-bound: the cache K and V of the row,
// read once, dominate (at the main path's vicuna-7b shape, B=4, S~600,
// Hkv=32, hd=128, bf16: ~38 MB per launch, ~11 us at 3.35 TB/s), while the
// G*W*(S+W)*hd*4 flops are far below the tensor-core ridge.  The design
// reads every cache byte once per row tile (the rows of a tile share each
// K/V tile; the main path's G*W = 8 rows are one tile) and keeps
// everything else on chip.  It does
// not yet split over S: with B*Hkv blocks (128 at the main path) each SM
// walks its whole row with synchronous loads, so it is latency-bound well
// above the byte bound.  A split-KV pass with an Eq.-1 merge, cp.async/TMA
// double buffering and wgmma are later work.
#include "attention_common.cuh"

namespace {

using namespace attn;

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
  int B, W, Hq, Hkv, hd, S, tile, rows;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) verify_attention_kernel(Args<T> a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int W = a.W, hd = a.hd, S = a.S, TS = a.tile;
  const int G = a.Hq / a.Hkv;
  const int GW = G * W;
  const int tid = threadIdx.x;
  const Smem s = carve(smem, GW, a.rows, W, hd, TS);

  load_queries(s, a.q, b, h, W, a.Hq, G, hd);
  for (int w = tid; w < W; w += kThreads) {
    s.qpos[w] = a.q_pos[b * W + w];
    s.lo[w] = a.lo[b * W + w];
  }
  for (int i = tid; i < W * W; i += kThreads) s.mask[i] = a.mask[i];
  __syncthreads();

  constexpr int VN = Vec<T>::N;
  const int nvec = hd / VN, kstride = hd + 1;
  for (int j0 = 0; j0 < S; j0 += TS) {
    for (int t = tid; t < TS; t += kThreads) {
      const int j = j0 + t;
      s.kp[t] = j < S ? a.key_pos[(size_t)b * S + j] : -1;
    }
    __syncthreads();

    // ---- K/V tile; empty slots and the ragged edge are zero
    for (int i = tid; i < TS * nvec; i += kThreads) {
      const int t = i / nvec, c = (i % nvec) * VN;
      float kf[VN], vf[VN];
      if (s.kp[t] >= 0) {
        const size_t off = ((size_t)(b * S + j0 + t) * a.Hkv + h) * hd + c;
        load_vec(a.ck + off, kf);
        load_vec(a.cv + off, vf);
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
    // ---- validity: filled, causal, inside the window
    for (int i = tid; i < s.nr * TS; i += kThreads) {
      const int t = i % TS, w = (s.r0 + i / TS) % W;
      const int kp = s.kp[t];
      s.ok[i] = kp >= 0 && kp <= s.qpos[w] && kp > s.lo[w];
    }
    __syncthreads();
    attend_tile(s, TS, hd, a.scale);
  }
  attend_tree(s, a.kn, a.vn, b, h, W, a.Hkv, hd, TS, a.scale);
  store_normalized(s, a.out, b, h, W, a.Hq, G, hd);
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.rows, a.W, a.hd, a.tile);
  cudaError_t err = cudaFuncSetAttribute(
      verify_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int GW = a.Hq / a.Hkv * a.W;
  const dim3 grid(a.B * a.Hkv, (GW + a.rows - 1) / a.rows);
  verify_attention_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* ck, const void* cv, const void* kn,
        const void* vn, const void* key_pos, const void* q_pos,
        const void* lo, const void* mask, void* out, int B, int W, int Hq,
        int Hkv, int hd, int S, int tile, int rows, float scale,
        void* stream) {
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
  a.rows = rows;
  a.scale = scale;
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

size_t verify_attention_smem_bytes(int rows, int W, int hd, int tile) {
  return attn::smem_bytes(rows, W, hd, tile);
}

const char* verify_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int verify_attention_f32(const void* q, const void* ck, const void* cv,
                         const void* kn, const void* vn, const void* key_pos,
                         const void* q_pos, const void* lo, const void* mask,
                         void* out, int B, int W, int Hq, int Hkv, int hd,
                         int S, int tile, int rows, float scale,
                         void* stream) {
  return run<float>(q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out, B, W,
                    Hq, Hkv, hd, S, tile, rows, scale, stream);
}

int verify_attention_bf16(const void* q, const void* ck, const void* cv,
                          const void* kn, const void* vn, const void* key_pos,
                          const void* q_pos, const void* lo, const void* mask,
                          void* out, int B, int W, int Hq, int Hkv, int hd,
                          int S, int tile, int rows, float scale,
                          void* stream) {
  return run<__nv_bfloat16>(q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out,
                            B, W, Hq, Hkv, hd, S, tile, rows, scale, stream);
}

}  // extern "C"
