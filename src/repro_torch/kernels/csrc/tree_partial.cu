// The W x W ancestor-masked attention of the tree queries over the W fresh
// tree KVs, in two forms:
//
//   * sparse_tree_attention_partial (the tree half of the split verify):
//     UNNORMALIZED online-softmax partials (o, m, l) that the caller merges
//     with the paged cache walk (paged_attention.cu, paged_cache_attention)
//     by the paper's Eq. 1.  Replaces the Pallas TPU kernel
//     src/repro/kernels/sparse_tree.py::sparse_tree_attention_partial (body
//     _partial_kernel) and computes exactly src/repro_torch/kernels/plain.py::
//     sparse_tree_attention_partial_plain: o (B, W, Hq, hd) fp32, m and l
//     (B, Hq, W) fp32, with m clamped to at least NEG_INF / 2 so an
//     all-masked row (l = 0) drops out of the merge.  The TPU kernel packs
//     (o, m, l) into one (G*W, hd + 2) block for its bounds lint; here the
//     three land directly in the merge layout.
//   * sparse_tree_attention (the tree part alone, normalized: the TPU
//     stand-in for the paper's ARM COO SpMM that the Fig. 10b study
//     measures): (p @ v) / max(l, 1e-30) in q's dtype.  Replaces the Pallas
//     TPU kernel src/repro/kernels/sparse_tree.py::sparse_tree_attention
//     (body _kernel) and computes exactly plain.py::
//     sparse_tree_attention_plain.
//
// Design.  One thread block per (batch row b, kv head h, tile of R query
// rows), as in the page walk: the query rows of the kv head and their
// accumulators sit in shared memory in fp32, the W tree KVs are staged in
// tiles of `tile` keys (16-byte vector loads of fp32 or bf16), and the
// masked scores, the online-softmax update and p @ V run on the CUDA cores
// in fp32.  The two forms differ only in their epilogue.  The TPU kernel
// computes the whole (G*W, W) score block in VMEM at once; a block of an
// H100 cannot hold it at the Fig. 10b shape (G*W = 256 rows of hd = 128
// plus their scores), so the rows are cut into tiles and the keys walked
// with the online softmax: each row's result is the same.
//
// Bound on an H100.  The work is small: at the main path (B=4, W=8,
// Hq=Hkv=32, hd=128) q and the tree KVs are ~0.8 MB and the output ~0.5 MB,
// under 1 us at 3.35 TB/s, and ~0.07 MFLOP per block; at the Fig. 10b
// shape (B=1, W=64, Hq=32, Hkv=8) ~0.4 GFLOP counted densely over the
// W x W block.  So launch latency and the serial per-tile barriers bound
// it; the design keeps it to one launch with every intermediate on chip.
#include "attention_common.cuh"

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

// The normalized tree attention: writes `out` in q's dtype.
int sparse_tree_attention(int q_dtype, const void* q, const void* kn,
                          const void* vn, const void* mask, void* out, int B,
                          int W, int Hq, int Hkv, int hd, int tile, int rows,
                          float scale, void* stream) {
  return by_q<true>(q_dtype, q, kn, vn, mask, out, nullptr, nullptr, nullptr,
                    B, W, Hq, Hkv, hd, tile, rows, scale, stream);
}

}  // extern "C"
