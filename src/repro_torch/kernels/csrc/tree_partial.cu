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
//     three land directly in the merge layout, in one buffer.
//   * sparse_tree_attention (the tree part alone, normalized, B5: the TPU
//     stand-in for the paper's ARM COO SpMM that the Fig. 10b study
//     measures): (p @ v) / max(l, 1e-30) in q's dtype.  Replaces the Pallas
//     TPU kernel src/repro/kernels/sparse_tree.py::sparse_tree_attention
//     (body _kernel) and computes plain.py::sparse_tree_attention_plain on
//     every row that sees a key (a tree row always sees itself); a row whose
//     mask is empty stores 0, as the TPU kernel does.
//
// B4 has two routes (partial_route; kernels/tree_partial.py states the same
// rule):
//   * W <= 64 and head_dim <= 128, fp32 or bf16 (tree_warp_kernel): the
//     main path's verify (W = 8, G = 1).  There a (b, kv head) pair is 8
//     query rows against 8 keys, 16K multiply-adds, and the time goes to
//     dependent global round trips, barriers and each thread's chain of
//     dependent instructions, not to arithmetic.  So a block holds 8 query
//     rows of one (b, kv head) on four warps: every copy of its rows and of
//     the pair's W keys and values is issued at once (16-byte cp.async,
//     rows past the end zero-filled), so the block pays one global round
//     trip and one block barrier, and each tree row's mask becomes a 64-bit
//     word in the same round trip.  All W keys fit one pass (no online
//     rescale).  A warp owns two rows; lane (row, key, head_dim part)
//     computes a score in exact fp32 from the staged rows (16-byte reads;
//     rows padded by 16 bytes, so the rows a quarter warp reads fall in
//     distinct banks), with the parts of a dot product on 2 lanes when a
//     row has 8 key slots; the masked row max and sum are shuffles within
//     the row's lanes; P goes to shared memory and P V runs with four
//     output columns a lane, stored from the registers.  Warp barriers
//     only after the staging; fp32 on the CUDA cores (no tensor cores: at
//     8 x 8 x 128 an mma tile would be mostly padding, and an unnormalized
//     o would need P in two bf16 terms).  The key slots a row holds are a
//     template (8, 16, 32, or 2 x 32 for W <= 64), so a small tree does
//     not pay for 64.  (One warp holding all 8 rows, the first version,
//     ran its whole chain alone: 6.5x its launch floor; PERF.md.)
//   * other shapes (a W = 256 prefill piece, head_dim > 128):
//     tree_partial_kernel, below.  One thread block per (batch row b, kv
//     head h, tile of R query rows): the query rows and their accumulators
//     sit in shared memory in fp32, the W tree KVs are staged in tiles of
//     `tile` keys, and the masked scores, the online-softmax update and
//     p @ V run on the CUDA cores in fp32, one thread per (row, key) dot
//     product.
// The host calls B4 through tree_partial_launch: a per-signature plan
// (TreePlan, built once by the wrapper), the operands' pointers, one
// output buffer and the stream, so a call converts 7 arguments.
// tree_floor_kernel, an empty kernel launched on a route's grid, block and
// shared memory (tree_partial_floor), is the floor chip_smoke.py measures
// beside the bound; no wrapper calls it.
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
// Hq=Hkv=32, hd=128, bf16) q and the tree KVs are ~0.8 MB and the partial
// ~0.5 MB, under 1 us at 3.35 TB/s; at the Fig. 10b shape in fp32, 2.5 MB
// of operands (0.75 us) and 0.067 GFLOP counted densely over the W x W
// block (0.004 GFLOP over the mask's 253 entries: 0.06 us at fp32's 67
// TFLOP/s outside the tensor cores).  So a launch, the staging latency and
// the per-block barriers bound it; every design keeps it to one launch
// with every intermediate on chip.
#include "attention_common.cuh"
#include "flash_common.cuh"

// The wrapper's per-signature plan (kernels/tree_partial.py::_TreePlan
// mirrors it field by field): built once per (shapes, dtypes, device),
// passed by pointer on every call.
struct TreePlan {
  int route;     // partial_route's choice (anything else is refused)
  int q_dtype;   // 0 = fp32, 1 = bf16
  int B, W, Hq, Hkv, hd;
  int tile, rows;  // route 0: key tile and query rows a block
  float scale;
};

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

// ---------------------------------------------------------------- B4, W <= 64
constexpr int kWarpRows = 8;      // query rows a block
constexpr int kWarpWarps = 4;     // warps a block: two rows each
constexpr int kWarpThreads = 32 * kWarpWarps;
constexpr int kWarpKeys = 64;     // the most keys a row (one pass)
constexpr int kWarpHdMax = 128;   // P V: four output columns a lane

// B4's routes (kernels/tree_partial.py::partial_route states the same
// rule): 1 = tree_warp_kernel, 0 = tree_partial_kernel.
int partial_route(int W, int hd) {
  return W <= kWarpKeys && hd <= kWarpHdMax ? 1 : 0;
}

// Key slots a row of tree_warp_kernel holds: W rounded up to 8, 16, 32, 64.
inline int warp_keys(int W) {
  return W <= 8 ? 8 : W <= 16 ? 16 : W <= 32 ? 32 : 64;
}

// Q (kWarpRows rows) and K (wmax rows) in q's dtype, rows padded by 16
// bytes; V (wmax rows) unpadded; P (kWarpRows x wmax) fp32; one 64-bit
// mask word per tree row.  Every region starts 16-byte aligned.
inline size_t warp_smem_bytes(int q_dtype, int W, int hd) {
  const size_t es = q_dtype == 1 ? 2 : 4, wmax = warp_keys(W);
  const size_t ld = hd + 16 / es;
  return ((kWarpRows + wmax) * ld + wmax * hd) * es + kWarpRows * wmax * 4 +
         (size_t)W * 8;
}

// four elements at p (8-byte aligned for bf16, 16 for fp32) in fp32
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16), f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16), f[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Query rows [y * 8, y * 8 + 8) of the G*W rows of (b, kv head h) =
// blockIdx.x (row r = g*W + w reads query head h*G + g), against all
// W <= KL * KPL keys in one pass; warp wp holds rows 2*wp and 2*wp + 1.
// In the scores lane (rs, ks, dp) holds rows 2*wp + rs + RS*i (i < RPL),
// keys ks + KL*j (j < KPL) and the head_dim chunks dp, dp + DP, ...: with
// few keys a row, lanes split each dot product instead of idling.  In P V
// it holds output columns 4*lane .. 4*lane + 3 of its warp's two rows.
template <typename TQ, int KL, int KPL>
__global__ void __launch_bounds__(kWarpThreads)
    tree_warp_kernel(const TQ* __restrict__ q, const TQ* __restrict__ kn,
                     const TQ* __restrict__ vn,
                     const uint8_t* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ m, float* __restrict__ l, int W,
                     int Hq, int Hkv, int hd, float scale) {
  constexpr int WMAX = KL * KPL;                  // key slots a row
  constexpr int RW = kWarpRows / kWarpWarps;      // rows a warp (2)
  constexpr int RS = KL * RW <= 32 ? RW : 1;      // row slots of a warp
  constexpr int DP = 32 / (KL * RS);              // lanes a dot product
  constexpr int RPL = RW / RS;                    // rows a lane scores
  constexpr int VN = Vec<TQ>::N;                  // elements a 16-byte copy
  static_assert(RS * KL * DP == 32, "lanes (row, key, head_dim part)");
  extern __shared__ __align__(16) char wsmem[];
  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv, GW = G * W, r0 = blockIdx.y * kWarpRows;
  const int ld = hd + VN, nv = hd / VN;
  TQ* Qs = reinterpret_cast<TQ*>(wsmem);
  TQ* Ks = Qs + kWarpRows * ld;
  TQ* Vs = Ks + WMAX * ld;
  float* Ps = reinterpret_cast<float*>(Vs + WMAX * hd);
  uint64_t* Mb = reinterpret_cast<uint64_t*>(Ps + kWarpRows * WMAX);

  // ---- one round trip: every row's copies in flight at once; a query row
  // past G*W and a key row past W are zero-filled (nothing read)
  for (int i = tid; i < (kWarpRows + 2 * WMAX) * nv; i += kWarpThreads) {
    const int row = i / nv, c = (i % nv) * VN;
    if (row < kWarpRows) {
      const int r = r0 + row;
      const bool ok = r < GW;
      const int g = ok ? r / W : 0, w = ok ? r % W : 0;
      flash::cp_async16(Qs + row * ld + c,
                        q + ((size_t)(b * W + w) * Hq + h * G + g) * hd + c,
                        ok);
    } else {
      const int kv = row - kWarpRows, t = kv % WMAX;
      const bool ok = t < W;
      const size_t off = ((size_t)(b * W + (ok ? t : 0)) * Hkv + h) * hd + c;
      if (kv < WMAX)
        flash::cp_async16(Ks + t * ld + c, kn + off, ok);
      else
        flash::cp_async16(Vs + t * hd + c, vn + off, ok);
    }
  }
  flash::cp_async_commit();
  // each tree row's mask as one word, bit t = key t (W <= 64)
  for (int w = tid; w < W; w += kWarpThreads) {
    uint64_t bits = 0;
#pragma unroll
    for (int t = 0; t < WMAX; ++t)
      if (t < W && mask[w * W + t]) bits |= 1ull << t;
    Mb[w] = bits;
  }
  flash::cp_async_wait<0>();
  __syncthreads();

  // ---- scores in exact fp32 (no TF32); the DP parts summed by shuffles
  const int dp = lane % DP, ks = lane / DP % KL, rs = lane / (DP * KL);
  const int row0 = wp * RW + rs;
  float s[RPL][KPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int ch = dp; ch < nv; ch += DP) {
    const int d = ch * VN;
    float kf[KPL][VN];
#pragma unroll
    for (int j = 0; j < KPL; ++j) load_vec(Ks + (ks + KL * j) * ld + d, kf[j]);
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      float qf[VN];
      load_vec(Qs + (row0 + RS * i) * ld + d, qf);
#pragma unroll
      for (int j = 0; j < KPL; ++j)
#pragma unroll
        for (int e = 0; e < VN; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
    }
  }

  // ---- one pass: the masked row max and sum over the row's KL key lanes
  // (a masked score never enters either; its probability is exactly 0),
  // m clamped to kNegInf / 2; P to shared memory, m and l to the merge
  // layout
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int lr = row0 + RS * i, r = r0 + lr;
    const bool valid = r < GW;
    const uint64_t bits = valid ? Mb[r % W] : 0;
    bool ok[KPL];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
#pragma unroll
      for (int off = 1; off < DP; off <<= 1)
        s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
      ok[j] = (bits >> (ks + KL * j)) & 1;
      s[i][j] *= scale;
      if (ok[j]) mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = DP; off < DP * KL; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mrow = fmaxf(mx, kNegInf * 0.5f);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float p = ok[j] ? expf(s[i][j] - mrow) : 0.f;
      if (dp == 0) Ps[lr * WMAX + ks + KL * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = DP; off < DP * KL; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (ks == 0 && dp == 0 && valid) {
      const size_t idx = ((size_t)b * Hq + h * G + r / W) * W + r % W;
      m[idx] = mrow;
      l[idx] = sum;
    }
  }
  __syncwarp();

  // ---- P V: columns c .. c+3 of the warp's rows; key rows past W are zero
  // and their P is 0, so the loop runs W rounded up to 4
  const int c = 4 * lane;
  if (c >= hd) return;
  float acc[RW][4];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  for (int t = 0; t < W; t += 4) {
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) load4(Vs + (t + u) * hd + c, v[u]);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float4 p =
          *reinterpret_cast<const float4*>(Ps + (wp * RW + r) * WMAX + t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[r][e] = fmaf(p.x, v[0][e], acc[r][e]);
        acc[r][e] = fmaf(p.y, v[1][e], acc[r][e]);
        acc[r][e] = fmaf(p.z, v[2][e], acc[r][e]);
        acc[r][e] = fmaf(p.w, v[3][e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int rr = r0 + wp * RW + r;
    if (rr >= GW) break;
    *reinterpret_cast<float4*>(
        o + ((size_t)(b * W + rr % W) * Hq + h * G + rr / W) * hd + c) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// The floor: an empty kernel on a route's grid, block and shared memory.
__global__ void tree_floor_kernel() {}

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
  static SmemAttr attr;
  const size_t smem = smem_bytes(rows, W, hd, tile);
  const cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(tree_partial_kernel<TQ, NORM>), attr);
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

template <typename TQ, int KL, int KPL>
int launch_warp(const TreePlan& p, const void* q, const void* kn,
                const void* vn, const void* mask, float* o, float* m,
                float* l, cudaStream_t st) {
  static SmemAttr attr;
  const size_t smem = warp_smem_bytes(p.q_dtype, p.W, p.hd);
  const cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(tree_warp_kernel<TQ, KL, KPL>), attr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.Hkv,
                  (p.Hq / p.Hkv * p.W + kWarpRows - 1) / kWarpRows);
  tree_warp_kernel<TQ, KL, KPL><<<grid, kWarpThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(kn),
      static_cast<const TQ*>(vn), static_cast<const uint8_t*>(mask), o, m, l,
      p.W, p.Hq, p.Hkv, p.hd, p.scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int by_keys(const TreePlan& p, const void* q, const void* kn, const void* vn,
            const void* mask, float* o, float* m, float* l,
            cudaStream_t st) {
  switch (warp_keys(p.W)) {
    case 8:
      return launch_warp<TQ, 8, 1>(p, q, kn, vn, mask, o, m, l, st);
    case 16:
      return launch_warp<TQ, 16, 1>(p, q, kn, vn, mask, o, m, l, st);
    case 32:
      return launch_warp<TQ, 32, 1>(p, q, kn, vn, mask, o, m, l, st);
  }
  return launch_warp<TQ, 32, 2>(p, q, kn, vn, mask, o, m, l, st);
}

}  // namespace

extern "C" {

size_t tree_partial_smem_bytes(int rows, int W, int hd, int tile) {
  return attn::smem_bytes(rows, W, hd, tile);
}

const char* tree_partial_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B4 as the wrapper calls it: the plan, the operands' pointers and one
// fp32 buffer holding the partials in the merge layout, o (B, W, Hq, hd)
// then m and l (B, Hq, W).  Route 1 runs only where partial_route picks it
// (tree_warp_kernel holds at most 64 keys and 128 columns); route 0,
// tree_partial_kernel, is right at any shape, and chip_smoke.py times it
// at the main shape through this entry.  Any other route or dtype is
// refused.
int tree_partial_launch(const TreePlan* p, const void* q, const void* kn,
                        const void* vn, const void* mask, float* out,
                        void* stream) {
  if ((p->route != 0 && p->route != 1) ||
      (p->route == 1 && partial_route(p->W, p->hd) != 1) ||
      (p->q_dtype != 0 && p->q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  float* o = out;
  float* m = o + (size_t)p->B * p->W * p->Hq * p->hd;
  float* l = m + (size_t)p->B * p->Hq * p->W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->route == 1)
    return p->q_dtype == 1
               ? by_keys<__nv_bfloat16>(*p, q, kn, vn, mask, o, m, l, st)
               : by_keys<float>(*p, q, kn, vn, mask, o, m, l, st);
  return by_q<false>(p->q_dtype, q, kn, vn, mask, nullptr, o, m, l, p->B,
                     p->W, p->Hq, p->Hkv, p->hd, p->tile, p->rows, p->scale,
                     stream);
}

// The floor of `p->route` (either route, whatever partial_route picks):
// tree_floor_kernel on that route's grid, block and shared memory.
int tree_partial_floor(const TreePlan* p, void* stream) {
  static attn::SmemAttr attr;
  const int GW = p->Hq / p->Hkv * p->W;
  const bool warp = p->route == 1;
  const int rows = warp ? kWarpRows : p->rows;
  const size_t smem = warp ? warp_smem_bytes(p->q_dtype, p->W, p->hd)
                           : attn::smem_bytes(p->rows, p->W, p->hd, p->tile);
  const cudaError_t err = attn::raise_smem(
      reinterpret_cast<const void*>(tree_floor_kernel), attr);
  if (err != cudaSuccess) return (int)err;
  tree_floor_kernel<<<dim3(p->B * p->Hkv, (GW + rows - 1) / rows),
                      warp ? kWarpThreads : attn::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
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
    static SmemAttr attr;
    const size_t smem = flash::layout(hd).total;
    err = raise_smem(reinterpret_cast<const void*>(tree_norm_flash_kernel),
                     attr);
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
    static SmemAttr attr[2];
    decltype(&tree_norm_f32_kernel<2>) kernel = nullptr;
    if (rows == 16) kernel = &tree_norm_f32_kernel<2>;
    if (rows == 32) kernel = &tree_norm_f32_kernel<4>;
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = f32_smem_bytes(rows, W, hd);
    err = raise_smem(reinterpret_cast<const void*>(kernel), attr[rows == 32]);
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
