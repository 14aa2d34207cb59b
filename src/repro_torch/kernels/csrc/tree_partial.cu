// The W x W ancestor-masked attention of the tree queries over the W fresh
// tree KVs, in two forms:
//
//   * sparse_tree_attention_partial (the tree half of the split verify,
//     B4): UNNORMALIZED online-softmax partials (o, m, l) that the caller
//     merges with the paged cache walk (paged_attention.cu,
//     paged_cache_attention) by the paper's Eq. 1.  Replaces the Pallas TPU
//     kernel src/repro/kernels/sparse_tree.py::sparse_tree_attention_partial
//     (body _partial_kernel) and computes exactly src/repro_torch/kernels/
//     plain.py::sparse_tree_attention_partial_plain: o (B, W, Hq, hd) fp32,
//     m and l (B, Hq, W) fp32, with m clamped to at least NEG_INF / 2 so an
//     all-masked row (l = 0) drops out of the merge.  The TPU kernel packs
//     (o, m, l) into one (G*W, hd + 2) block for its bounds lint; here the
//     three land directly in the merge layout.
//   * sparse_tree_attention (the tree part alone, normalized, B5: the TPU
//     stand-in for the paper's ARM COO SpMM that the Fig. 10b study
//     measures): (p @ v) / max(l, 1e-30) in q's dtype.  Replaces the Pallas
//     TPU kernel src/repro/kernels/sparse_tree.py::sparse_tree_attention
//     (body _kernel) and computes plain.py::sparse_tree_attention_plain on
//     every row that sees a key (a tree row always sees itself); a row whose
//     mask is empty stores 0, as the TPU kernel does.
//
// B4's design (tree_partial_kernel, also B5's route for the shapes below
// that neither other route takes).  One thread block per (batch row b, kv
// head h, tile of R query rows): the query rows and their accumulators sit
// in shared memory in fp32, the W tree KVs are staged in tiles of `tile`
// keys, and the masked scores, the online-softmax update and p @ V run on
// the CUDA cores in fp32, one thread per (row, key) dot product.
//
// B5's design: the time of the Fig. 10b shape (B=1, W=64, Hq=32, Hkv=8,
// hd=128: 256 query rows per kv head against ONE key tile) went into too
// few blocks (B*Hkv = 8 kv heads) and one dot product per thread.  Its
// kernels cut each kv head's G*W rows into small row tiles, picked on the
// host (kernels/tree_partial.py::norm_rows: the largest tile that still
// gives ~one block per SM), so Fig. 10b runs 128 blocks of 16 rows:
//   * bf16, head_dim <= 128 (tree_norm_flash_kernel): flash_common.cuh's
//     tree walk (TreeSlots through the cp.async ring, ldmatrix, mma.sync
//     m16n8k16 with fp32 accumulation, P rounded to bf16); a block of 16
//     rows splits each 64-key tile over its four warps and folds them;
//     the output o / max(l, 1e-30) is stored in bf16 from the registers.
//   * fp32, W <= 64 and head_dim <= 128 (tree_norm_f32_kernel): exact fp32
//     on the CUDA cores (no TF32: the sweeps hold 2e-5).  Q, K and V of the
//     block's rows and the kv head's W keys are staged in shared memory;
//     each thread computes a register tile of RPT rows x 4 keys of scores
//     (float4 reads of Q rows and K rows padded to hd + 4 floats, so the
//     eight rows a quarter-warp reads fall in distinct banks), then, since
//     all W keys fit one tile, ONE pass: the masked row max by shuffles,
//     exp, the row sum, P in shared memory, and P V with a register tile
//     of 2 * RPT rows x 4 columns a thread, normalized on the store.
//   * other shapes (fp32 with W > 64 or head_dim > 128, bf16 head_dim >
//     128): tree_partial_kernel's normalized epilogue.
//
// Bound on an H100.  The work is small: at the main path (B=4, W=8,
// Hq=Hkv=32, hd=128) q and the tree KVs are ~0.8 MB and the output
// ~0.5 MB, under 1 us at 3.35 TB/s; at the Fig. 10b shape in fp32, 2.5 MB
// of operands (0.75 us) and 0.067 GFLOP counted densely over the W x W
// block (0.004 GFLOP over the mask's 253 entries: 0.06 us at fp32's 67
// TFLOP/s outside the tensor cores).  So a launch, the staging latency and
// the per-block barriers bound it; every design keeps it to one launch
// with every intermediate on chip.
#include "attention_common.cuh"
#include "flash_common.cuh"

namespace {

using namespace attn;

// NORM: write o / max(l, 1e-30) into `out` (q's dtype); else the partials.
template <typename TQ, bool NORM>
__global__ void __launch_bounds__(kThreads)
    tree_partial_kernel(const TQ* q, const TQ* kn, const TQ* vn,
                        const uint8_t* mask, TQ* out, float* o, float* m,
                        float* l, int W, int Hq, int Hkv, int hd, int tile,
                        int rows, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const Smem s = carve(smem, G * W, rows, W, hd, tile);
  load_queries(s, q, b, h, W, Hq, G, hd);
  for (int i = threadIdx.x; i < W * W; i += kThreads) s.mask[i] = mask[i];
  __syncthreads();
  attend_tree(s, kn, vn, b, h, W, Hkv, hd, tile, scale);
  if constexpr (NORM)
    store_normalized(s, out, b, h, W, Hq, G, hd);
  else
    store_partials(s, o, m, l, b, h, W, Hq, G, hd);
}

// B5 on the tensor cores: bf16, head_dim <= 128, `rows` query rows a block.
__global__ void __launch_bounds__(flash::kThreads)
    tree_norm_flash_kernel(const __nv_bfloat16* q, const __nv_bfloat16* kn,
                           const __nv_bfloat16* vn, const uint8_t* mask,
                           __nv_bfloat16* out, int W, int Hq, int Hkv, int hd,
                           int rows, float scale) {
  extern __shared__ __align__(16) char fsmem[];
  const flash::Block k = flash::make_block(Hkv, W, Hq, hd, rows, scale);
  const flash::TreeSlots tree{kn, vn, mask, k.b, k.h, W, Hkv, hd};
  flash::tree_block(fsmem, tree, k, q, out);
}

// B5 in exact fp32 on the CUDA cores: W <= kF32Keys (one key tile, one
// pass), head_dim <= kF32HdMax, 8 * RPT query rows a block.
constexpr int kF32Threads = 128;
constexpr int kF32Keys = 64;
constexpr int kF32HdMax = 128;

// Q (R rows) and K (kF32Keys rows) padded to hd + 4 floats, V, P (R x
// kF32Keys), the row sums, then the W x W mask bytes.
__host__ __device__ inline size_t f32_smem_bytes(int R, int W, int hd) {
  const size_t ld = hd + 4;
  return ((R + kF32Keys) * ld + (size_t)kF32Keys * hd +
          (size_t)R * kF32Keys + R) * 4 + (size_t)W * W;
}

template <int RPT>
__global__ void __launch_bounds__(kF32Threads)
    tree_norm_f32_kernel(const float* q, const float* kn, const float* vn,
                         const uint8_t* mask, float* out, int W, int Hq,
                         int Hkv, int hd, float scale) {
  constexpr int R = 8 * RPT;     // rows a block: 8 row groups of RPT
  constexpr int RPV = 2 * RPT;   // rows a thread holds in P V (4 groups)
  extern __shared__ __align__(16) float fs[];
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv, r0 = blockIdx.y * R, nr = min(R, G * W - r0);
  const int ld = hd + 4, n4 = hd / 4, tid = threadIdx.x;
  float* Qs = fs;
  float* Ks = Qs + R * ld;
  float* Vs = Ks + kF32Keys * ld;
  float* Ps = Vs + kF32Keys * hd;
  float* Ls = Ps + R * kF32Keys;
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Ls + R);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // ---- stage the rows (zero past nr), the W keys (zero past W), the mask
#pragma unroll 4
  for (int i = tid; i < R * n4; i += kF32Threads) {
    const int lr = i / n4, c = (i % n4) * 4;
    float4 v = zero;
    if (lr < nr) {
      const int r = r0 + lr, g = r / W, w = r % W;
      v = *reinterpret_cast<const float4*>(
          q + ((size_t)(b * W + w) * Hq + h * G + g) * hd + c);
    }
    *reinterpret_cast<float4*>(Qs + lr * ld + c) = v;
  }
#pragma unroll 4
  for (int i = tid; i < kF32Keys * n4; i += kF32Threads) {
    const int t = i / n4, c = (i % n4) * 4;
    float4 kv = zero, vv = zero;
    if (t < W) {
      const size_t off = ((size_t)(b * W + t) * Hkv + h) * hd + c;
      kv = *reinterpret_cast<const float4*>(kn + off);
      vv = *reinterpret_cast<const float4*>(vn + off);
    }
    *reinterpret_cast<float4*>(Ks + t * ld + c) = kv;
    *reinterpret_cast<float4*>(Vs + t * hd + c) = vv;
  }
  for (int i = tid; i < W * W; i += kF32Threads) Ms[i] = mask[i];
  __syncthreads();

  // ---- scores: row group ty holds rows ty*RPT + i, key lane tx keys
  // tx + 16*j; the 16 threads of a row group are one half-warp
  const int tx = tid % 16, ty = tid / 16;
  float s[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float4 qv[RPT], kv[4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RPT + i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
  }

  // ---- one pass: masked row max, exp, row sum; P into shared memory.
  // A masked score never enters max or sum (its probability is exactly
  // 0), so a row with no key keeps l = 0 and stores 0.
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int lr = ty * RPT + i;
    const int w = (r0 + lr) % W;
    bool ok[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tx + 16 * j;
      ok[j] = lr < nr && t < W && Ms[w * W + t];
      s[i][j] *= scale;
      if (ok[j]) mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? expf(s[i][j] - mx) : 0.f;
      Ps[lr * kF32Keys + tx + 16 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tx == 0) Ls[lr] = sum;
  }
  __syncthreads();

  // ---- P V: warp cy holds rows cy*RPV + i, lane cx columns 4*cx .. +3;
  // normalized on the store
  const int cx = tid % 32, cy = tid / 32, c = cx * 4;
  if (c >= hd) return;
  float4 acc[RPV];
#pragma unroll
  for (int i = 0; i < RPV; ++i) acc[i] = zero;
  for (int t = 0; t < W; ++t) {
    const float4 v = *reinterpret_cast<const float4*>(Vs + t * hd + c);
#pragma unroll
    for (int i = 0; i < RPV; ++i) {
      const float p = Ps[(cy * RPV + i) * kF32Keys + t];
      acc[i].x = fmaf(p, v.x, acc[i].x);
      acc[i].y = fmaf(p, v.y, acc[i].y);
      acc[i].z = fmaf(p, v.z, acc[i].z);
      acc[i].w = fmaf(p, v.w, acc[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < RPV; ++i) {
    const int lr = cy * RPV + i;
    if (lr >= nr) continue;
    const int r = r0 + lr, g = r / W, w = r % W;
    const float inv = 1.0f / fmaxf(Ls[lr], 1e-30f);
    *reinterpret_cast<float4*>(
        out + ((size_t)(b * W + w) * Hq + h * G + g) * hd + c) =
        make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                    acc[i].w * inv);
  }
}

template <typename TQ, bool NORM>
int run(const void* q, const void* kn, const void* vn, const void* mask,
        void* out, void* o, void* m, void* l, int B, int W, int Hq, int Hkv,
        int hd, int tile, int rows, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows, W, hd, tile);
  cudaError_t err = cudaFuncSetAttribute(
      tree_partial_kernel<TQ, NORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (Hq / Hkv * W + rows - 1) / rows);
  tree_partial_kernel<TQ, NORM><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), static_cast<const uint8_t*>(mask),
      static_cast<TQ*>(out), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), W, Hq, Hkv, hd, tile, rows, scale);
  return (int)cudaGetLastError();
}

// q_dtype: 0 = fp32, 1 = bf16 (q, k_new, v_new and `out` share it)
template <bool NORM>
int by_q(int q_dtype, const void* q, const void* kn, const void* vn,
         const void* mask, void* out, void* o, void* m, void* l, int B, int W,
         int Hq, int Hkv, int hd, int tile, int rows, float scale,
         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return run<float, NORM>(q, kn, vn, mask, out, o, m, l, B, W, Hq, Hkv,
                              hd, tile, rows, scale, st);
    case 1:
      return run<__nv_bfloat16, NORM>(q, kn, vn, mask, out, o, m, l, B, W, Hq,
                                      Hkv, hd, tile, rows, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// B5's routes (kernels/tree_partial.py::norm_route states the same rule):
// 1 = tensor cores, 2 = the fp32 one-pass kernel, 0 = tree_partial_kernel.
int norm_route(int q_dtype, int W, int hd) {
  if (q_dtype == 1 && hd <= flash::kHdMax) return 1;
  if (q_dtype == 0 && W <= kF32Keys && hd <= kF32HdMax) return 2;
  return 0;
}

}  // namespace

extern "C" {

size_t tree_partial_smem_bytes(int rows, int W, int hd, int tile) {
  return attn::smem_bytes(rows, W, hd, tile);
}

const char* tree_partial_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The split verify's tree half: writes the partials o, m, l.
int sparse_tree_attention_partial(int q_dtype, const void* q, const void* kn,
                                  const void* vn, const void* mask, void* o,
                                  void* m, void* l, int B, int W, int Hq,
                                  int Hkv, int hd, int tile, int rows,
                                  float scale, void* stream) {
  return by_q<false>(q_dtype, q, kn, vn, mask, nullptr, o, m, l, B, W, Hq,
                     Hkv, hd, tile, rows, scale, stream);
}

// The normalized tree attention: writes `out` in q's dtype.  `route` is
// norm_route's choice (anything else is refused); `rows` the query rows a
// block (route 1: 16, 32 or 64; route 2: 16 or 32); `tile` the key tile
// of route 0 (with its rows from kernels/launch.py::pick_tiles).
int sparse_tree_attention(int q_dtype, const void* q, const void* kn,
                          const void* vn, const void* mask, void* out, int B,
                          int W, int Hq, int Hkv, int hd, int route, int tile,
                          int rows, float scale, void* stream) {
  if (route != norm_route(q_dtype, W, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hkv, (Hq / Hkv * W + rows - 1) / rows);
  cudaError_t err;
  if (route == 1) {
    if (rows != 16 && rows != 32 && rows != flash::kRows)
      return (int)cudaErrorInvalidValue;
    const size_t smem = flash::layout(hd).total;
    err = cudaFuncSetAttribute(tree_norm_flash_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    tree_norm_flash_kernel<<<grid, flash::kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kn),
        static_cast<const __nv_bfloat16*>(vn),
        static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out),
        W, Hq, Hkv, hd, rows, scale);
    return (int)cudaGetLastError();
  }
  if (route == 2) {
    decltype(&tree_norm_f32_kernel<2>) kernel = nullptr;
    if (rows == 16) kernel = &tree_norm_f32_kernel<2>;
    if (rows == 32) kernel = &tree_norm_f32_kernel<4>;
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = f32_smem_bytes(rows, W, hd);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kF32Threads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(kn),
        static_cast<const float*>(vn), static_cast<const uint8_t*>(mask),
        static_cast<float*>(out), W, Hq, Hkv, hd, scale);
    return (int)cudaGetLastError();
  }
  return by_q<true>(q_dtype, q, kn, vn, mask, out, nullptr, nullptr, nullptr,
                    B, W, Hq, Hkv, hd, tile, rows, scale, stream);
}

}  // extern "C"
