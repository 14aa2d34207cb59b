// Tree half of the split verify: the W x W ancestor-masked attention of the
// tree queries over the W fresh tree KVs, as UNNORMALIZED online-softmax
// partials (o, m, l) that the caller merges with the paged cache walk
// (paged_attention.cu, paged_cache_attention) by the paper's Eq. 1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_tree.py::
// sparse_tree_attention_partial (body _partial_kernel), and computes exactly
// src/repro_torch/kernels/plain.py::sparse_tree_attention_partial_plain:
// o (B, W, Hq, hd) fp32, m and l (B, Hq, W) fp32, with m clamped to at
// least NEG_INF / 2 so an all-masked row (l = 0) drops out of the merge.
// The TPU kernel packs (o, m, l) into one (G*W, hd + 2) block for its
// bounds lint; here the three land directly in the merge layout.
//
// Design.  One thread block per (batch row b, kv head h), as in the page
// walk: the G*W query rows of the kv head and their accumulators sit in
// shared memory in fp32, the W tree KVs are staged in tiles of `tile` keys
// (16-byte vector loads of fp32 or bf16), and the masked scores, the
// online-softmax update and p @ V run on the CUDA cores in fp32.
//
// Bound on an H100.  The work is tiny: at the main path (B=4, W=8,
// Hq=Hkv=32, hd=128) q and the tree KVs are ~0.8 MB and the output ~0.5 MB,
// under 1 us at 3.35 TB/s, and ~0.07 MFLOP per block.  So launch latency
// and the serial per-tile barriers bound it; the design keeps it to one
// launch with every intermediate on chip.
#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    tree_partial_kernel(const TQ* q, const TQ* kn, const TQ* vn,
                        const uint8_t* mask, float* o, float* m, float* l,
                        int W, int Hq, int Hkv, int hd, int tile,
                        float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int GW = G * W;
  const Smem s = carve(smem, GW, W, hd, tile);
  load_queries(s, q, b, h, W, Hq, G, hd);
  for (int i = threadIdx.x; i < W * W; i += kThreads) s.mask[i] = mask[i];
  __syncthreads();
  attend_tree(s, kn, vn, b, h, W, Hkv, GW, hd, tile, scale);
  store_partials(s, o, m, l, b, h, W, Hq, G, hd);
}

template <typename TQ>
int run(const void* q, const void* kn, const void* vn, const void* mask,
        void* o, void* m, void* l, int B, int W, int Hq, int Hkv, int hd,
        int tile, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv * W, W, hd, tile);
  cudaError_t err = cudaFuncSetAttribute(
      tree_partial_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tree_partial_kernel<TQ><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), static_cast<const uint8_t*>(mask),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      W, Hq, Hkv, hd, tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t tree_partial_smem_bytes(int GW, int W, int hd, int tile) {
  return attn::smem_bytes(GW, W, hd, tile);
}

const char* tree_partial_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_dtype: 0 = fp32, 1 = bf16 (q, k_new and v_new share it)
int sparse_tree_attention_partial(int q_dtype, const void* q, const void* kn,
                                  const void* vn, const void* mask, void* o,
                                  void* m, void* l, int B, int W, int Hq,
                                  int Hkv, int hd, int tile, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return run<float>(q, kn, vn, mask, o, m, l, B, W, Hq, Hkv, hd, tile,
                        scale, st);
    case 1:
      return run<__nv_bfloat16>(q, kn, vn, mask, o, m, l, B, W, Hq, Hkv, hd,
                                tile, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
