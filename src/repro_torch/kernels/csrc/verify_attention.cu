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
// Design (flash-decoding split, flash_common.cuh).  The grid is (B*Hkv,
// row tiles, parts): a block takes one (batch row b, kv head h), one tile
// of the G*W query rows that read kv head h (query head h*G + g, row
// r = g*W + w, the reference's grouping), and one contiguous range of
// cache slots (a whole number of key tiles), the W tree nodes under the
// ancestor mask, or both (a tree of at most one tile is walked by the
// last split's block; a wider one, a W=256 prefill piece, has blocks of
// its own).  Each block writes its unnormalized fp32 (o, m, l) partial to
// a workspace; merge_kernel, a second launch from the same entry point,
// folds the parts by Eq. 1 (the math of models/common.py::merge_partials)
// into the output.  n_split is chosen on the host from the shapes alone
// (kernels/launch.py::pick_split): as many splits as fill the card's
// resident block slots once (the occupancy query below times the SM
// count; 2 x 132 on an H100 SXM), which at B*Hkv = 128 is 256 blocks.
// That split loop over the slots takes
// the place of the TPU kernel's sequential grid axis; the ragged cache
// edge is masked here, never padded by the caller.
//
// Under bf16 queries (the main path) with head_dim <= 128 the products run
// on the tensor cores (mma.sync m16n8k16, fp32 accumulation; a warp holds
// 16 query rows with their Q fragments, O and m, l in registers, and with
// G*W <= 32 rows the four warps split each key tile instead), K and V
// tiles are staged in bf16 by cp.async into a three-stage ring (two tiles
// in flight while one computes; empty slots, key_pos < 0, are zero-filled,
// never read), and the mask is computed from each score's own (row, slot)
// coordinates, or skipped for a tile every row sees whole.  With G*W < 16
// rows (decode W=1, verify W=8 at G=1) the 16-row fragment is padded:
// bytes bound those shapes, not the products.  Under fp32 queries (the
// reference's sweeps, 2e-5), or head_dim above 128, the products stay on
// the CUDA cores in fp32 (attention_common.cuh's attend_tile, no TF32), in
// the same split grid with the tree as a part of its own.
//
// Bound on an H100.  The work is bytes-bound: the row's filled cache K and
// V, read once, dominate (at the main path's vicuna-7b shape, B=4, S~600,
// Hkv=32, hd=128, bf16: ~38 MB per launch, ~11 us at 3.35 TB/s); the
// G*W*(S+W)*hd*4 flops are far below the tensor-core ridge, and a W=256
// prefill piece (B=1, 256 cached slots) reads ~13 MB against ~3 GFLOP.
// Every cache byte is read once per row tile (kRows = 64 rows share each
// K/V tile); the partials (parts x B*W*Hq*(hd + 2) floats) go through L2
// to the merge.  What remains above the bound is each block's fixed cost
// (its first copies' latency, the Q loads, the partial's store) against
// two to five tiles of streaming: see PERF.md.
#include "attention_common.cuh"
#include "flash_common.cuh"

#include <type_traits>

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
  float* ws_o;            // (parts, B, W, Hq, hd) partials
  float* ws_m;            // (parts, B, Hq, W)
  float* ws_l;
  int B, W, Hq, Hkv, hd, S, tile, rows, nsplit, split_len, parts;
  float scale;
};

// The bf16 tensor-core path: bf16 queries, head_dim within the register
// tiles.  kernels/launch.py::flash_route states the same rule.
template <typename T>
constexpr bool kFlashType = std::is_same<T, __nv_bfloat16>::value;
inline bool use_flash(bool bf16, int hd) {
  return bf16 && hd <= flash::kHdMax;
}

__global__ void __launch_bounds__(flash::kThreads)
    verify_flash_kernel(Args<__nv_bfloat16> a) {
  extern __shared__ __align__(16) char fsmem[];
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const flash::DenseSlots<__nv_bfloat16> cache{a.ck,  a.cv,  a.key_pos, b,
                                               h,     a.S,   a.Hkv,     a.hd};
  const flash::TreeSlots tree{a.kn, a.vn, a.mask, b, h, a.W, a.Hkv, a.hd};
  flash::split_block(fsmem, cache, tree, a.q, a.q_pos, a.lo, a.ws_o, a.ws_m,
                     a.ws_l, a.B, a.Hq, a.S, a.nsplit, a.split_len, a.parts,
                     a.scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) verify_attention_kernel(Args<T> a) {
  // CUDA-core products (fp32 queries, or head_dim above the register
  // tiles): block z >= 1 walks slot range z - 1, z == 0 the tree
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
  const int z = blockIdx.z;
  const int jb = z > 0 ? (z - 1) * a.split_len : S;
  const int je = min(S, jb + a.split_len);
  for (int j0 = jb; j0 < je; j0 += TS) {
    for (int t = tid; t < TS; t += kThreads) {
      const int j = j0 + t;
      s.kp[t] = j < je ? a.key_pos[(size_t)b * S + j] : -1;
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
  if (z == 0) attend_tree(s, a.kn, a.vn, b, h, W, a.Hkv, hd, TS, a.scale);
  const size_t n_o = (size_t)a.B * W * a.Hq * hd, n_m = (size_t)a.B * a.Hq * W;
  store_partials(s, a.ws_o + z * n_o, a.ws_m + z * n_m, a.ws_l + z * n_m, b,
                 h, W, a.Hq, G, hd);
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int GW = a.Hq / a.Hkv * a.W;
  cudaError_t err;
  if (use_flash(kFlashType<T>, a.hd)) {
    if constexpr (kFlashType<T>) {
      if (a.tile != flash::kTile || a.rows != flash::kRows ||
          a.parts != a.nsplit + (a.W > flash::kTile))
        return (int)cudaErrorInvalidValue;
      static SmemAttr attr;
      const size_t smem = flash::layout(a.hd).total;
      err = raise_smem(reinterpret_cast<const void*>(verify_flash_kernel),
                       attr);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(a.B * a.Hkv, (GW + flash::kRows - 1) / flash::kRows,
                      a.parts);
      verify_flash_kernel<<<grid, flash::kThreads, smem, stream>>>(a);
    }
  } else {
    if (a.parts != a.nsplit + 1) return (int)cudaErrorInvalidValue;
    static SmemAttr attr;
    const size_t smem = smem_bytes(a.rows, a.W, a.hd, a.tile);
    err = raise_smem(reinterpret_cast<const void*>(verify_attention_kernel<T>),
                     attr);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(a.B * a.Hkv, (GW + a.rows - 1) / a.rows, a.nsplit + 1);
    verify_attention_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = a.B * a.W * a.Hq * (a.hd / 4);
  flash::merge_kernel<T><<<(threads + 127) / 128, 128, 0, stream>>>(
      a.ws_o, a.ws_m, a.ws_l, a.parts, a.out, a.B, a.W, a.Hq, a.hd);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* ptr, const int* dims, float scale, void* stream) {
  Args<T> a;
  a.q = static_cast<const T*>(ptr[0]);
  a.ck = static_cast<const T*>(ptr[1]);
  a.cv = static_cast<const T*>(ptr[2]);
  a.kn = static_cast<const T*>(ptr[3]);
  a.vn = static_cast<const T*>(ptr[4]);
  a.key_pos = static_cast<const int*>(ptr[5]);
  a.q_pos = static_cast<const int*>(ptr[6]);
  a.lo = static_cast<const int*>(ptr[7]);
  a.mask = static_cast<const uint8_t*>(ptr[8]);
  a.out = static_cast<T*>(const_cast<void*>(ptr[9]));
  a.ws_o = static_cast<float*>(const_cast<void*>(ptr[10]));
  a.ws_m = static_cast<float*>(const_cast<void*>(ptr[11]));
  a.ws_l = static_cast<float*>(const_cast<void*>(ptr[12]));
  a.B = dims[0];
  a.W = dims[1];
  a.Hq = dims[2];
  a.Hkv = dims[3];
  a.hd = dims[4];
  a.S = dims[5];
  a.tile = dims[6];
  a.rows = dims[7];
  a.nsplit = dims[8];
  a.split_len = dims[9];
  a.parts = dims[10];
  a.scale = scale;
  return launch(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Shared memory of a CUDA-core block of `rows` query rows at `tile` keys.
size_t verify_attention_smem_bytes(int rows, int W, int hd, int tile) {
  return attn::smem_bytes(rows, W, hd, tile);
}

// Shared memory of a tensor-core block (flash_common.cuh's layout).
size_t verify_attention_flash_smem_bytes(int hd) {
  return flash::layout(hd).total;
}

// Blocks of the tensor-core walk resident on one SM (the occupancy query;
// kernels/launch.py::split_plan sizes the split with it).
int verify_attention_flash_blocks_per_sm(int hd) {
  static attn::SmemAttr attr;
  const int smem = (int)flash::layout(hd).total;
  int n = 0;
  if (attn::raise_smem(reinterpret_cast<const void*>(verify_flash_kernel),
                       attr) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, verify_flash_kernel, flash::kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

const char* verify_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Both take q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out and the
// workspace ws_o, ws_m, ws_l; then B, W, Hq, Hkv, hd, S, the key tile and
// rows per block (kTile, kRows on the tensor-core path), n_split, the
// split length in slots and the parts (n_split + 1; n_split on the
// tensor-core path when W <= kTile); the scale and the stream.  Two
// launches: the split walk, then the merge.
int verify_attention_f32(const void* q, const void* ck, const void* cv,
                         const void* kn, const void* vn, const void* key_pos,
                         const void* q_pos, const void* lo, const void* mask,
                         void* out, void* ws_o, void* ws_m, void* ws_l, int B,
                         int W, int Hq, int Hkv, int hd, int S, int tile,
                         int rows, int nsplit, int split_len, int parts,
                         float scale, void* stream) {
  const void* ptr[] = {q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out,
                       ws_o, ws_m, ws_l};
  const int dims[] = {B,    W,    Hq,      Hkv,       hd,   S,
                      tile, rows, nsplit,  split_len, parts};
  return run<float>(ptr, dims, scale, stream);
}

int verify_attention_bf16(const void* q, const void* ck, const void* cv,
                          const void* kn, const void* vn, const void* key_pos,
                          const void* q_pos, const void* lo, const void* mask,
                          void* out, void* ws_o, void* ws_m, void* ws_l,
                          int B, int W, int Hq, int Hkv, int hd, int S,
                          int tile, int rows, int nsplit, int split_len,
                          int parts, float scale, void* stream) {
  const void* ptr[] = {q, ck, cv, kn, vn, key_pos, q_pos, lo, mask, out,
                       ws_o, ws_m, ws_l};
  const int dims[] = {B,    W,    Hq,      Hkv,       hd,   S,
                      tile, rows, nsplit,  split_len, parts};
  return run<__nv_bfloat16>(ptr, dims, scale, stream);
}

}  // extern "C"
