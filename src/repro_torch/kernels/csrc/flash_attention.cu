// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry
// point that Python loads with ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py.  It computes the same function:
//
//   logits = (q . k) / sqrt(D), then cap * tanh(logits / cap) when a cap is set,
//   then, only when causal, positions the mask excludes become -2**30:
//   allowed(i, j) = (j <= i and j > i - window) or j < prefix_len,
//   softmax over the kv axis in fp32, out = p @ v / max(l, 1e-37) in q's type.
//
// q: [B, H, Sq, D]; k, v: [B, Hkv, Skv, D]; query head h reads kv head
// h / (H / Hkv).  Rows and columns are positions from 0, also when Sq != Skv.
// Unlike the Pallas kernel, Sq and Skv may be any length: tail rows are never
// stored and padded kv columns get -inf, so they never enter the softmax.
// A masked (not padded) column keeps the -2**30 fill, so a row the mask
// excludes entirely averages v over all Skv columns, as the reference does.
// Every tensor is read through its strides (the model passes transposed
// [B, S, H, D] views); only the head dim must be contiguous.
//
// What bounds it on an H100: at the serving shapes (S ~ 1k, D = 128) the work
// is ~4*S*D operations per loaded byte, far above the card's ~295 ops/byte, so
// the bound is the tensor cores' 989 TFLOP/s (bf16).  The TPU grid's
// sequential kv axis becomes a loop inside the block, so m, l and the output
// accumulator stay in registers for the whole row tile and no partial result
// goes to device memory.  kv tiles wholly above the causal diagonal, or
// wholly below a sliding window, are skipped where every row keeps an
// unmasked column, which halves the causal work.
//
// bf16 (what serving runs): the tensor-core path, `flash_fwd_bf16`.  Both
// products are warpgroup MMAs (wgmma, m64nNk16, f32 accumulators in
// registers; inline PTX in csrc/hopper.cuh): S = Q.K^T with Q and K read
// from shared memory (K-major), and O += P.V with P from registers and V
// from shared memory (MN-major).  The online softmax runs on S's
// accumulator fragments, each row's max and sum reduced over the 4 threads
// that hold it; the mask is applied only on tiles that cross the diagonal,
// a window, the prefix or the ragged edge.  P goes to the tensor cores as
// two bf16 parts, its rounding and the rounded remainder, so P.V carries
// P to ~2**-17 rather than bf16's 2**-9, for one more product per tile:
// the output then agrees with the fp32 reference to within its own bf16
// rounding, also where it is large.
//
// Block: one warpgroup of 64 q rows (two at D = 256) and kv tiles of 64.
// Q is loaded once; V streams through two stages of shared memory, K
// through one, by 16-byte cp.async loads zero-filled past Skv, stored in
// the 128-byte swizzle (32 and 64 bytes at D = 16, 32) that the wgmma
// descriptors name.  Iteration t issues S[t] and P[t-1].V[t-1] together,
// loads K[t+1] once S[t] is done and V[t] from its start, so every load has
// the softmax or a whole iteration to land.  At D = 128 a block holds 65 KB
// of shared memory and at most 168 registers a thread, so three blocks
// share an SM and one's softmax and loads run beside another's products:
// with one block of 64 or 128 rows per SM the tensor cores idle through
// each softmax.  q tiles launch longest first (the grid's slowest axis,
// reversed) so the causal blocks balance over the SMs.

// fp32: `flash_fwd_f32`, products as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), so it keeps the exact fp32 arithmetic the 1e-4 checks hold it to.
// Block: one (b, h, 64-row q tile), 256 threads as a 16 x 16 grid.  Thread
// (ty, tx) owns rows ty + 16*i and, per kv tile, columns tx + 16*j; the 16
// threads of one row group share a half warp, so row max and row sum reduce
// with shuffles.  Q, K, V tiles are staged as fp32 in shared memory with one
// float of padding per row, which keeps the strided reads free of bank
// conflicts.  For D = 256 the kv tile is 32 rows so the tiles fit in 140 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as in the reference

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int h, hkv, sq, skv;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int causal, window, prefix_len;  // window <= 0: none
  float scale, logit_cap;          // logit_cap <= 0: none
};

// The kv tiles [t_begin, t_end) of width bk that rows [q0, q0 + rows) visit.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int rows,
                                         int bk, int& t_begin, int& t_end) {
  const int q_last = min(q0 + rows, p.sq) - 1;
  t_begin = 0;
  t_end = (p.skv + bk - 1) / bk;
  if (p.causal) {
    // above the diagonal: no row may attend past max(q_last, prefix_len - 1).
    // Skipping happens only when q_last < skv, where every row i keeps j = i.
    const int j_hi = max(q_last, p.prefix_len - 1);
    t_end = min(t_end, j_hi / bk + 1);
    // below the window: tiles whose columns all lie at or before
    // q0 - window, for rows that each keep their own column
    if (p.window > 0 && p.prefix_len == 0 && q_last < p.skv) {
      t_begin = max(0, (q0 - p.window + 1) / bk);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

namespace bf16 {

using hopper::Wgmma;
typedef __nv_bfloat16 T;

constexpr float kLog2e = 1.4426950408889634f;

// D <= 128: one warpgroup of 64 q rows per block, so several blocks share
// an SM (three at D = 128: 65 KB of shared memory each).  D = 256: two
// warpgroups share each K and V tile (160 KB, one block per SM).
template <int D>
struct Tiles {
  static constexpr int WGS = D >= 256 ? 2 : 1;  // warpgroups per block
  static constexpr int BLOCKS = D >= 256 ? 1 : 3;  // per SM, for registers
  static constexpr int THREADS = 128 * WGS;
  static constexpr int ROWS = 64 * WGS;         // q rows per block
  static constexpr int BK = 64;                 // kv rows per tile
  static constexpr int CB = hopper::TileShape<D>::CB;  // column block
  static constexpr int W = hopper::TileShape<D>::W;    // bytes per its row
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // Q, one stage of K, two of V; 1024 bytes to align the start
  static constexpr int SMEM = 1024 + Q_BYTES + 3 * KV_BYTES;
};

// This thread's share of a tile load (csrc/hopper.cuh).
template <int D>
using Loader = hopper::TileLoader<D, Tiles<D>::THREADS>;

// S = Q K^T for one warpgroup: q = its 64 rows of the Q tile, k = a K tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<D>::BK / 2],
                                         uint32_t q, uint32_t k) {
  using L = Tiles<D>;
  constexpr int W = L::W, CB = L::CB;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t blk = (kk * 16) / CB, col = (kk * 16) % CB * 2;
    Wgmma<L::BK>::template ss<0>(
        s, hopper::smem_desc<W>(q + blk * L::ROWS * W + col, 16, 8 * W),
        hopper::smem_desc<W>(k + blk * L::BK * W + col, 16, 8 * W), kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P V for one warpgroup: pa = P as bf16 pairs, v = a V tile.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[Tiles<D>::BK / 4],
                                         uint32_t v) {
  using L = Tiles<D>;
  constexpr int W = L::W;
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    Wgmma<D>::template rs<1>(
        o, a, hopper::smem_desc<W>(v + kk * 16 * W, L::BK * W, 8 * W), 1);
  }
}

// Per thread: its two rows' running max m and sum l, and the rescale c of
// the last tile.
struct Rows {
  float m[2], l[2], c[2];
};

// Cap and mask the S fragment of kv tile j0 in place, update the row
// maxima, and replace each entry by exp(logit - max) (f32).  S and the
// maxima stay in units of q.k: the scale 1/sqrt(D) is folded into exp2's
// argument, so a capped logit is stored divided by it, and a masked one as
// -2**30 divided by it (one value for every masked entry).
template <int NS>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[NS],
                                             Rows& rows, int j0, int w_lo,
                                             int w_hi, int r0, int quad) {
  constexpr int BK = 2 * NS;
  if (p.logit_cap > 0.f) {
    // cap tanh(x / cap) = cap (1 - 2 / (exp(2 x / cap) + 1)): two MUFU ops
    // and few registers per entry; absolute error ~1e-7 cap
    const float in = 2.f * kLog2e * p.scale / p.logit_cap;
    const float out = p.logit_cap / p.scale;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      s[i] = out - 2.f * out * __frcp_rn(hopper::ex2(s[i] * in) + 1.f);
  }
  // every (row, column) of this warpgroup's tile is allowed unless it
  // crosses the ragged edge, the diagonal, the window or the prefix
  bool edge = j0 + BK > p.skv;
  if (p.causal && !(j0 + BK <= p.prefix_len)) {
    const bool below = j0 + BK - 1 <= w_lo;
    const bool inside = p.window <= 0 || j0 > w_hi - p.window;
    edge = edge || !(below && inside);
  }
  if (edge) {
    // f32::masked() without branches (they cost registers and time here)
    const float fill = kNegInf / p.scale;
    const int window = p.causal && p.window > 0 ? p.window : 1 << 30;
    const int prefix = p.causal ? p.prefix_len : 0;
    const int diag = p.causal ? 0 : 1 << 30;  // allowed: c <= r + diag
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = j0 + 8 * (i / 4) + 2 * quad + (i % 2);
      const int r = (i % 4) < 2 ? r0 : r0 + 8;
      const bool ok = (c <= r + diag && c > r - window) || c < prefix;
      s[i] = c >= p.skv ? -INFINITY : ok ? s[i] : fill;
    }
  }
  // every tile holds a real column, so the new max is finite
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
  }
  const float k = p.scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    const float m_new = fmaxf(rows.m[r], mx[r]);
    rows.c[r] = hopper::ex2((rows.m[r] - m_new) * k);
    rows.m[r] = m_new;
  }
  const float b0 = rows.m[0] * k, b1 = rows.m[1] * k;
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    s[i] = hopper::ex2(fmaf(s[i], k, -b0));
    s[i + 1] = hopper::ex2(fmaf(s[i + 1], k, -b0));
    s[i + 2] = hopper::ex2(fmaf(s[i + 2], k, -b1));
    s[i + 3] = hopper::ex2(fmaf(s[i + 3], k, -b1));
  }
}

// Rescale O by the last tile's c, split P into two bf16 parts, pa (the
// rounded P) and pl = P - pa (rounded again), the A operands of two
// products with V, and add P to this thread's share of the row sums.
// pa + pl is P to ~2**-17: with pa alone, P.V would carry P's bf16 rounding
// (2**-9), enough to flip the rounding of a large output (|o| >= 4 in a
// row that a few columns dominate) by one bf16 ulp past the 2e-2 the
// output is held to.
template <int NS, int NO>
__device__ __forceinline__ void to_p(const float (&s)[NS],
                                     uint32_t (&pa)[NS / 2],
                                     uint32_t (&pl)[NS / 2], float (&o)[NO],
                                     Rows& rows) {
  // late tiles seldom move a row's max: skip the multiply by 1 then
  if (__any_sync(0xffffffffu, rows.c[0] != 1.f || rows.c[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      o[i] *= rows.c[0];
      o[i + 1] *= rows.c[0];
      o[i + 2] *= rows.c[1];
      o[i + 3] *= rows.c[1];
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    pa[i / 2] = hopper::pack_bf16(s[i], s[i + 1]);
    pl[i / 2] = hopper::pack_bf16(s[i] - hopper::bf16_lo(pa[i / 2]),
                                  s[i + 1] - hopper::bf16_hi(pa[i / 2]));
    sum[(i / 2) % 2] += s[i] + s[i + 1];
  }
  rows.l[0] = rows.l[0] * rows.c[0] + sum[0];
  rows.l[1] = rows.l[1] * rows.c[1] + sum[1];
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, Tiles<D>::BLOCKS)
flash_fwd_bf16(const Params p) {
  using L = Tiles<D>;
  constexpr int BK = L::BK;
  constexpr int NS = BK / 2;  // S accumulator floats per thread
  constexpr int NO = D / 2;   // O accumulator floats per thread

  // shared memory: Q, then K's stage, then V's two
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + L::Q_BYTES, s_v = s_k + L::KV_BYTES;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, quad = lane % 4;
  const int n_qt = (p.sq + L::ROWS - 1) / L::ROWS;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * L::ROWS;  // longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.h / p.hkv);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  int t_begin, t_end;
  kv_range(p, q0, L::ROWS, BK, t_begin, t_end);
  // V's stage of kv tile t
  auto stage = [&](int t) { return (uint32_t)((t - t_begin) & 1) * L::KV_BYTES; };

  // this warpgroup's rows, and the two rows this thread holds
  const int w_lo = q0 + 64 * wg, w_hi = w_lo + 63;
  const int r0 = w_lo + 16 * warp + lane / 4;
  const uint32_t s_qw = s_q + wg * 64 * L::W;

  const Loader<D> ld(tid);

  // Software pipeline: iteration t issues S[t] = Q K[t]^T and
  // O += P[t-1] V[t-1] together, then takes the softmax of S[t].  V[t] is
  // loaded from the top of iteration t, into the stage V[t-2] left; K[t+1]
  // as soon as every warp's S[t] is done, into K's one stage, and lands
  // during the softmax.
  ld.template load<L::ROWS>(s_q, qp, p.q_ss, q0, p.sq);
  ld.template load<BK>(s_k, kp, p.k_ss, t_begin * BK, p.skv);
  hopper::cp_async_commit();

  float o[NO], s[NS];
  uint32_t pa[NS / 2], pl[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) pa[i] = pl[i] = 0;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  Rows rows = {{-INFINITY, -INFINITY}, {0.f, 0.f}, {0.f, 0.f}};

  for (int t = t_begin; t < t_end; ++t) {
    hopper::cp_async_wait<0>();  // K[t], V[t-1]
    hopper::fence_proxy_async();
    __syncthreads();  // ... landed for every thread; V[t-2] is free
    ld.template load<BK>(s_v + stage(t), vp, p.v_ss, t * BK, p.skv);
    hopper::cp_async_commit();

    hopper::fence_operands(s);
    hopper::fence_operands(o);
    hopper::wgmma_fence();
    issue_qk<D>(s, s_qw, s_k);
    if (t > t_begin) {
      issue_pv<D>(o, pa, s_v + stage(t - 1));
      issue_pv<D>(o, pl, s_v + stage(t - 1));
    }
    hopper::wgmma_commit();
    if (t > t_begin)
      hopper::wgmma_wait<1>();  // S done; P.V may still run
    else
      hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    if (t + 1 < t_end) {
      __syncthreads();  // every warp's S[t] is done: K's stage is free
      ld.template load<BK>(s_k, kp, p.k_ss, (t + 1) * BK, p.skv);
      hopper::cp_async_commit();
    }
    softmax_tile(p, s, rows, t * BK, w_lo, w_hi, r0, quad);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    hopper::fence_operands(pa);
    hopper::fence_operands(pl);
    to_p(s, pa, pl, o, rows);
  }
  // the last tile's P.V
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  hopper::wgmma_fence();
  issue_pv<D>(o, pa, s_v + stage(t_end - 1));
  issue_pv<D>(o, pl, s_v + stage(t_end - 1));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(o);

  float l0 = rows.l[0], l1 = rows.l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int c = 8 * (i / 4) + 2 * quad;
    if (r0 < p.sq)
      *reinterpret_cast<uint32_t*>(op + r0 * p.o_ss + c) =
          hopper::pack_bf16(o[i] * inv0, o[i + 1] * inv0);
    if (r1 < p.sq)
      *reinterpret_cast<uint32_t*>(op + r1 * p.o_ss + c) =
          hopper::pack_bf16(o[i + 2] * inv1, o[i + 3] * inv1);
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  // set once per device, so a CUDA graph capture finds it done
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tiles<D>::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid(p.h, b, (p.sq + Tiles<D>::ROWS - 1) / Tiles<D>::ROWS);
  flash_fwd_bf16<D><<<grid, Tiles<D>::THREADS, Tiles<D>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// fp32: CUDA cores

namespace f32 {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;

// Logit x of row r, column c, masked as the reference does.
__device__ __forceinline__ float masked(const Params& p, float x, int r,
                                        int c) {
  if (c >= p.skv) return -INFINITY;  // padding: never enters the softmax
  if (p.causal) {
    bool ok = c <= r;
    if (p.window > 0) ok = ok && c > r - p.window;
    if (p.prefix_len > 0) ok = ok || c < p.prefix_len;
    if (!ok) return kNegInf;
  }
  return x;
}

__host__ __device__ constexpr int kv_tile(int d) { return d >= 256 ? 32 : 64; }

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kBlockQ * (d + 1) + 2 * kv_tile(d) * (d + 1) +
                                  kBlockQ * (kv_tile(d) + 1));
}

// Rows [row0, row0 + rows) of a [S, D] slice into shared memory, zero past s.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int row0, int rows,
                                          int s) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? src[row * stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const Params p) {
  constexpr int BK = kv_tile(D);
  constexpr int LD = D + 1;        // padded row of Q, K, V in shared memory
  constexpr int LP = BK + 1;       // padded row of P
  constexpr int RQ = kBlockQ / 16; // rows per thread
  constexpr int CK = BK / 16;      // kv columns per thread
  constexpr int CD = D / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockQ * LD;
  float* sv = sk + BK * LD;
  float* sp = sv + BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int hk = h / (p.h / p.hkv);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<D>(sq, qp, p.q_ss, q0, kBlockQ, p.sq);

  int t_begin, t_end;
  kv_range(p, q0, kBlockQ, BK, t_begin, t_end);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<D>(sk, kp, p.k_ss, j0, BK, p.skv);
    load_tile<D>(sv, vp, p.v_ss, j0, BK, p.skv);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float x = s[i][j] * p.scale;
        if (p.logit_cap > 0.f) x = p.logit_cap * tanhf(x / p.logit_cap);
        x = masked(p, x, r, j0 + tx + 16 * j);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds a real column, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float e = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * LP + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = sp[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sv[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < CD; ++c) op[r * p.o_ss + tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.h, b);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

template <int D>
cudaError_t launch_d(const Params& p, int b, int dtype, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<D>(p, b, stream);
  if (dtype == 1) return bf16::launch<D>(p, b, stream);
  return cudaErrorInvalidValue;
}

// The bf16 path's 16-byte loads need 16-byte aligned rows.
bool rows_aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         sh % 8 == 0 && ss % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Strides are in elements; the last dimension of every tensor is contiguous;
// for bfloat16, every pointer is 16-byte aligned and every stride a multiple
// of 8.  Returns the CUDA error of the launch (0 on success).
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int b, int h, int hkv, int sq, int skv, int d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, int window, int prefix_len, float logit_cap, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (dtype == 1 && !(rows_aligned(q, q_sb, q_sh, q_ss) &&
                      rows_aligned(k, k_sb, k_sh, k_ss) &&
                      rows_aligned(v, v_sb, v_sh, v_ss) &&
                      rows_aligned(o, o_sb, o_sh, o_ss)))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.prefix_len = prefix_len;
  p.scale = 1.0f / sqrtf((float)d);
  p.logit_cap = logit_cap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch_d<16>(p, b, dtype, s);
    case 32: return (int)launch_d<32>(p, b, dtype, s);
    case 64: return (int)launch_d<64>(p, b, dtype, s);
    case 128: return (int)launch_d<128>(p, b, dtype, s);
    case 256: return (int)launch_d<256>(p, b, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
