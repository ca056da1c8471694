// Mamba2 SSD intra-chunk block for Hopper (sm_90a), CUDA C++ with a plain C
// entry point that Python loads with ctypes.
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel` / `ssd_chunk_intra` in
// src/repro/kernels/ssd_scan.py:32.  (A second entry point,
// `repro_ssd_chunk_bwd`, is the block's backward, which replaces no TPU
// kernel: its section below.)  For every (batch, head, chunk of Q rows) it
// computes, with cum = cumsum(dt * a) over the chunk:
//
//   L[i, j] = exp(cum[i] - cum[j]) for i >= j, else 0            [Q, Q]
//   y[i]    = sum_j (C[i] . B[j]) L[i, j] x[j] dt[j]             [Q, P]
//   state   = sum_j exp(cum[Q-1] - cum[j]) (x[j] dt[j]) (x) B[j] [P, N]
//
// y is written in x's type, state in float32.  cum is summed in float64 and
// each difference is rounded to float32 once, as the plain version
// (ssd_chunk_intra_reference) does: a float32 cumsum over 512 rows leaves
// errors near 1e-4 in L that depend on the order of the sum.  The mask is a
// select, never a product: above the diagonal cum[i] - cum[j] > 0 and exp
// may overflow to inf, and inf * 0 is NaN.
//
// Layout: tensors are read and written through strides in elements, with
// the last dimension contiguous: x [B, H, S, P], dt [B, H, S] and a [B, H]
// float32, b and c [B, H, S, N], y [B, H, S, P], states [B, H, S/Q, P, N].
// A head stride of 0 for b and c makes every head read one shared [S, N]
// (Mamba2's single group), so the H-fold copy the Pallas kernel asks for
// upstream is never made; the model's [B, S, H, P] tensors are passed as
// transposed views, so nothing is copied either.
//
// What bounds it on an H100: at mamba2-780m's prefill shape (Q = 512, P = 64,
// N = 128; B = 2, S = 2048, 48 heads) the two causal Q x Q products and the
// state do ~340 operations per byte of x, dt, b, c, y and the states moved,
// just above the card's ~295 for bf16 tensor cores: the bound is the
// operations (0.023 ms), with the bytes close behind (0.020 ms); at
// zamba2-1.2b's Q = 256, N = 64 it is the bytes.  So the products belong on
// the tensor cores, and L (1 MiB per chunk at Q = 512) must never reach
// memory.  What holds this kernel above that bound is not the products:
// per 64 x 64 score tile, the decay math costs a float64 difference, its
// rounding and an expf per entry on the CUDA cores (the conversion and the
// exponential run at a quarter of the float32 rate, about as many cycles as
// the tile's products take on the tensor cores), and every row tile reads
// the B and x tiles of all the key tiles before it again from L2.
//
// bf16 (what serving runs): `ssd_chunk_bf16`, all three products as
// warpgroup MMAs (wgmma m64nNk16, f32 accumulators; csrc/hopper.cuh).  One
// warpgroup per block, and a block's 64 rows are one of two kinds.
//   A y block takes 64 query rows of a chunk and walks the key tiles of 64
//   up to the diagonal (the ones above it are skipped): S = C . B^T from
//   shared memory, both K-major (`ss`); then, on S's accumulator fragments,
//   v = S * L * dt[j] with L from cum in shared memory, the mask a select
//   on the tile that crosses the diagonal only; v goes to the tensor cores
//   in two bf16 parts, its rounding and the rounded remainder (v to
//   ~2**-16, where bf16 alone keeps 2**-8), as the A operand in registers
//   (`rs`), and y += v . x with x MN-major.  x stays exact bf16 because dt
//   is folded into v.
//   A state block takes 64 of the state's N rows, transposed: st^T[N, P] =
//   (w o B)^T . x, w[j] = exp(cum[Q-1] - cum[j]) dt[j].  That is the y of
//   query rows whose C rows are the unit vectors e_n and whose cum is
//   cum[Q-1], so the state block runs the y block's loop with an identity
//   tile for C: S = I . B^T gives B^T's rows exactly, in the accumulator
//   layout that is the A operand's, w is folded in and split as above, and
//   x is the MN-major B operand of the same `rs` product.  Of the two forms
//   of a transposed product that the wrappers allow, (w o B)^T as A
//   fragments was taken over a transposed-A `ss` product: it keeps B and x
//   exact, needs no scaled copy of B in shared memory, and shares the y
//   block's pipeline (built from scalar loads in a loop of their own, the
//   fragments made the state blocks the slowest part of the kernel).
// Operand tiles come straight from global memory in bf16, by 16-byte
// cp.async into the swizzle the descriptors name, zero-filled past the
// chunk: C once, B through one stage (reloaded as soon as S is done, and
// landing during the decay math) and x through two (a whole iteration to
// land).  A state block loads only its 64 columns of B.  cum and dt come
// from a pre-pass, `ssd_chunk_cum`, that sums each chunk's cum once into a
// work buffer, so the blocks copy them with the tiles instead of each
// summing the chunk again.  At P = 64, N = 128, Q = 512 a block holds 55 KB
// of shared memory and 128 registers a thread, so four blocks share an SM
// and one's decay math and loads run beside another's products (two
// B stages, the first layout, left room for three blocks and ran slower).
// The grid's slowest axis puts the state blocks first, then the row tiles
// longest first, so the blocks that walk all Q / 64 key tiles do not
// finish last.
//
// fp32: `ssd_chunk_f32`, products as fp32 FMAs on the CUDA cores, so it
// keeps the exact fp32 arithmetic the 1e-4 checks hold it to.  It is
// bit-equal to the plain version on the card for every chunk from 16 to
// 4096 rows that chip_smoke.py runs, with one exception: a chunk of one
// row.  Each sum here runs in order, one fused multiply-add per term (the
// score C[i] . B[j] over n, y over the keys j, the state over the rows);
// the plain version's products are cuBLAS GEMMs, which sum in the same
// order at these shapes, but at Q = 1 the score is a 1 x N by N x 1
// product that cuBLAS reduces as a dot product in an order of its own.  y
// then differs from the plain version by that sum's rounding, a few
// float32 ulps of |C[i]| |B[j]| summed over n times x dt (9.5e-7 at
// N = 16 in the run that found it); the states, a sum over one row, stay
// equal.  Phase 13 prints such cases and holds them to this order.  Grid: (ceil(Q / 64) + 1, S / Q, B * H).
// Block x < ceil(Q / 64) computes y for 64 query rows of the chunk: it
// stages C[i] once and loops over key tiles of 64 rows, staging B[j] and
// x[j] dt[j], forming the 64 x 64 tile of scores (C . B) * L in shared
// memory, and adding its product with x dt into a [64, P] float32
// accumulator in registers.  The last block x computes the chunk's [P, N]
// state, looping over the chunk's rows in tiles of 64 with B pre-scaled by
// its decay.  256 threads as a 16 x 16 grid: thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j of each tile; shared rows are padded by
// one float, so the strided reads are free of bank conflicts.  Every block
// sums the chunk's cum itself.
//
// cum is summed by chunk_cumsum in both paths, in one order: kRuns runs of
// rows, each summed in order, then the run totals scanned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;          // query rows per block, key rows per step
constexpr int kMaxChunk = 4096;    // cum and dt of one chunk in shared memory
constexpr int kRuns = 256;         // threads (and runs) of the cumsum

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* st;
  void* work;      // bf16: cum and dt per (batch, head, chunk)
  int heads, chunk, row_tiles;
  int64_t x_sb, x_sh, x_ss;
  int64_t dt_sb, dt_sh, dt_ss;
  int64_t a_sb, a_sh;
  int64_t b_sb, b_sh, b_ss;
  int64_t c_sb, c_sh, c_ss;
  int64_t y_sb, y_sh, y_ss;
  int64_t st_sb, st_sh, st_sl;
};

// cum[j] = sum_{t <= j} (float)(dt[j] * a), summed in double by kRuns
// threads: each sums a run of ceil(q / kRuns) rows in order, then the run
// totals are scanned and each run adds the total before it.
__device__ void chunk_cumsum(double* cum, double* runs, const float* sdt,
                             float a, int q) {
  const int t = threadIdx.x;
  const int per = (q + kRuns - 1) / kRuns;
  const int lo = min(t * per, q), hi = min(lo + per, q);
  double s = 0.0;
  for (int j = lo; j < hi; ++j) {
    const float da = sdt[j] * a;    // the float32 product, then the sum
    s += (double)da;
    cum[j] = s;
  }
  runs[t] = s;
  __syncthreads();
  for (int off = 1; off < kRuns; off <<= 1) {   // inclusive scan of runs
    const double v = t >= off ? runs[t - off] : 0.0;
    __syncthreads();
    runs[t] += v;
    __syncthreads();
  }
  const double base = t > 0 ? runs[t - 1] : 0.0;
  for (int j = lo; j < hi; ++j) cum[j] += base;
  __syncthreads();
}

// Sets the largest dynamic shared memory a kernel may ask for, once per
// device, so a CUDA graph capture finds it done.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

namespace bf16 {

using hopper::Wgmma;
typedef __nv_bfloat16 T;

constexpr int kThreads = 128;      // one warpgroup

template <int P, int N>
struct Tiles {
  static constexpr int NS = N < 64 ? N : 64;    // state rows per state block
  static constexpr int STATE_BLOCKS = N / NS;
  static constexpr int BLOCKS = P >= 128 ? 2 : 4;  // per SM, for registers
  static constexpr int C_BYTES = kTile * N * 2;    // C, and B's one stage
  static constexpr int X_BYTES = kTile * P * 2;    // each of x's two stages
  static constexpr int TILE_BYTES = 2 * C_BYTES + 2 * X_BYTES;

  // 1024 to align the tiles, then cum (double) and dt over the chunk padded
  // to whole tiles
  static constexpr size_t smem(int padded) {
    return 1024 + TILE_BYTES + 12 * (size_t)padded;
  }
};

// The work buffer: per (batch, head, chunk), cum (double) and dt (float)
// of the chunk's rows padded to whole tiles, zero past the chunk.
__host__ __device__ constexpr size_t work_bytes(int padded) {
  return 12 * (size_t)padded;
}

// Fills the work buffer: one block of kRuns threads per (batch * head,
// chunk) sums cum with chunk_cumsum, in the order of the fp32 kernel, so
// the bf16 blocks load it with cp.async instead of each summing it again.
__global__ void __launch_bounds__(kRuns) ssd_chunk_cum(const Params p) {
  __shared__ double runs[kRuns];
  extern __shared__ float sdt[];              // [chunk]
  const int q = p.chunk, padded = p.row_tiles * kTile;
  const int bi = blockIdx.x / p.heads, hi = blockIdx.x % p.heads;
  const int64_t row0 = (int64_t)blockIdx.y * q;
  const float* dtp = p.dt + bi * p.dt_sb + hi * p.dt_sh + row0 * p.dt_ss;
  uint8_t* out = static_cast<uint8_t*>(p.work) +
                 ((int64_t)blockIdx.x * gridDim.y + blockIdx.y) *
                     work_bytes(padded);
  double* cum = reinterpret_cast<double*>(out);
  float* dt = reinterpret_cast<float*>(out + 8 * (size_t)padded);
  for (int j = threadIdx.x; j < q; j += kRuns) sdt[j] = dtp[j * p.dt_ss];
  __syncthreads();
  chunk_cumsum(cum, runs, sdt, p.a[bi * p.a_sb + hi * p.a_sh], q);
  for (int j = threadIdx.x; j < padded; j += kRuns) {
    dt[j] = j < q ? sdt[j] : 0.f;
    if (j >= q) cum[j] = 0.0;
  }
}

// The block's view of shared memory and of its (batch, head, chunk).
struct Block {
  uint32_t s_c, s_b, s_x;   // tiles: C, B's stage, x's two stages
  double* cum;               // [padded]
  float* sdt;                // [padded]
  const T* x;
  const T* b;
  const T* c;
  const uint8_t* work;       // this chunk's cum and dt in the work buffer
  int64_t row0;              // the chunk's first row
  int bi, hi;
};

// cum and dt of rows [0, rows) (a multiple of kTile) from the work buffer,
// by cp.async into the block's current group.
__device__ __forceinline__ void load_cum(const Params& p, const Block& k,
                                         int rows) {
  const int padded = p.row_tiles * kTile;
  const int cum_chunks = rows / 2, all = cum_chunks + rows / 4;
  for (int i = threadIdx.x; i < all; i += kThreads) {
    const int off = i < cum_chunks ? 16 * i
                                   : 8 * padded + 16 * (i - cum_chunks);
    hopper::cp_async_16(hopper::smem_addr(k.cum) + off, k.work + off, 16);
  }
}

// S = C B^T for the warpgroup over the K columns [16 k0, 16 (k0 + STEPS)):
// c = the C tile, b = a B tile (both K-major).
template <int N, int STEPS>
__device__ __forceinline__ void issue_scores(float (&s)[kTile / 2], uint32_t c,
                                             uint32_t b, int k0) {
  constexpr int W = hopper::TileShape<N>::W, CB = hopper::TileShape<N>::CB;
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int kk = k0 + i;
    const uint32_t off = (kk * 16) / CB * (kTile * W) + (kk * 16) % CB * 2;
    Wgmma<kTile>::template ss<0>(
        s, hopper::smem_desc<W>(c + off, 16, 8 * W),
        hopper::smem_desc<W>(b + off, 16, 8 * W), i > 0);
  }
  hopper::wgmma_commit();
}

// acc += A x for the warpgroup: a = A [64 x 64] as bf16 pairs in the
// fragment layout, x = an x tile (MN-major).
template <int P>
__device__ __forceinline__ void issue_times_x(float (&acc)[P / 2],
                                              const uint32_t (&a)[16],
                                              uint32_t x) {
  constexpr int W = hopper::TileShape<P>::W;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    Wgmma<P>::template rs<1>(
        acc, ak, hopper::smem_desc<W>(x + kk * 16 * W, kTile * W, 8 * W), 1);
  }
}

// v and its rounded remainder as two bf16 operands: hi + lo is v to ~2**-16
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = hopper::pack_bf16(v0, v1);
  lo = hopper::pack_bf16(v0 - hopper::bf16_lo(hi), v1 - hopper::bf16_hi(hi));
}

// The identity rows [n0, n0 + 64) of an [N, N] matrix into the C tile, so
// that S = C B^T is B^T's rows n0 .. n0 + 63 exactly (zero rows from N on).
template <int N>
__device__ __forceinline__ void store_identity(const Block& k, int n0) {
  using Load = hopper::TileLoader<N, kThreads>;
  const Load lc(threadIdx.x);
  // the generic address of shared-memory address 0
  uint8_t* raw = reinterpret_cast<uint8_t*>(k.cum) - hopper::smem_addr(k.cum);
#pragma unroll
  for (int i = 0; i < kTile / Load::STEP; ++i) {
    const int m = lc.row + i * Load::STEP, col = n0 + m - 8 * lc.chunk;
    uint32_t w[4] = {0, 0, 0, 0};          // bf16 1.0 at element `col`
    if (col >= 0 && col < 8) w[col / 2] = 0x3F80u << (16 * (col % 2));
    *reinterpret_cast<uint4*>(raw + k.s_c +
                              Load::template offset<kTile>(m, lc.chunk)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One block's 64 rows.  A y block (n0 < 0): y for rows [i0, i0 + 64) of
// the chunk, i0 = 64 rt, over key tiles 0 .. rt, the last one on the
// diagonal.  A state block: rows [n0, n0 + NS) of the state transposed,
// st^T[n] = sum_j B[j][n] exp(cum[q-1] - cum[j]) dt[j] x[j], which is the y
// of a query row whose C is e_n and whose cum is cum[q-1], so the same loop
// computes it with the identity for C (and only B's columns [n0, n0 + NS)),
// over every key tile, the last one cut at q.
template <int P, int N>
__device__ __forceinline__ void rows_block(const Params& p, const Block& k,
                                           int rt, int n0) {
  using L = Tiles<P, N>;
  constexpr int NO = P / 2;           // y accumulator floats per thread
  const bool state = n0 >= 0;
  const int q = p.chunk, i0 = rt * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const hopper::TileLoader<N, kThreads> lc(tid);
  const hopper::TileLoader<P, kThreads> lx(tid);
  // a state block loads only its columns of B
  const bool b_cols = !state || lc.chunk / (L::NS / 8) == n0 / L::NS;
  auto x_stage = [&](int t) { return k.s_x + (uint32_t)(t & 1) * L::X_BYTES; };
  auto load_b = [&](int t) {
    if (b_cols) lc.template load<kTile>(k.s_b, k.b, p.b_ss, t * kTile, q);
  };

  // Software pipeline, as flash's: iteration t issues S[t] = C B[t]^T and
  // y += v[t-1] x[t-1] together, then forms v[t] from S[t].  x[t] is loaded
  // from the top of iteration t, into the stage the products of x[t-2]
  // left; B[t+1] as soon as every warp's S[t] is done, into B's one stage,
  // and lands during the decay math.
  if (state)
    store_identity<N>(k, n0);
  else
    lc.template load<kTile>(k.s_c, k.c, p.c_ss, i0, q);
  load_b(0);
  const int t_last = state ? p.row_tiles - 1 : rt;
  load_cum(p, k, (t_last + 1) * kTile);
  hopper::cp_async_commit();

  // the last key column each of this thread's two rows takes
  const int r = 16 * warp + lane / 4;   // this thread's rows: r, r + 8
  const int last_a = state ? q - 1 : i0 + r;
  const int last_b = state ? q - 1 : i0 + r + 8;
  float y[NO], s[kTile / 2];
  uint32_t vh[16], vl[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) vh[i] = vl[i] = 0;
#pragma unroll
  for (int i = 0; i < NO; ++i) y[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) s[i] = 0.f;

  for (int t = 0; t <= t_last; ++t) {
    hopper::cp_async_wait<0>();   // B[t], x[t-1] (and C, cum at t = 0)
    hopper::fence_proxy_async();
    __syncthreads();              // ... landed for every thread
    lx.template load<kTile>(x_stage(t), k.x, p.x_ss, t * kTile, q);
    hopper::cp_async_commit();

    hopper::fence_operands(s);
    hopper::fence_operands(y);
    hopper::wgmma_fence();
    if (state)
      issue_scores<N, L::NS / 16>(s, k.s_c, k.s_b, n0 / 16);
    else
      issue_scores<N, N / 16>(s, k.s_c, k.s_b, 0);
    if (t > 0) {
      issue_times_x<P>(y, vh, x_stage(t - 1));
      issue_times_x<P>(y, vl, x_stage(t - 1));
    }
    hopper::wgmma_commit();
    if (t > 0)
      hopper::wgmma_wait<1>();    // S done; y's products may still run
    else
      hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    if (t < t_last) {
      __syncthreads();            // every warp's S[t] is done: B is free
      load_b(t + 1);
      hopper::cp_async_commit();
    }
    // v = S * L * dt[j] on the fragments: s[4i + e] is row r + 8 (e / 2),
    // column j0 + 8 i + 2 quad + e % 2
    const double cum_a = k.cum[last_a], cum_b = k.cum[last_b];
    const int j0 = t * kTile;
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 2 * (i + quad) + e;   // 8 (i / 4) + 2 quad + e
        const double cj = k.cum[j];
        const float d = k.sdt[j];
        const float la = expf((float)(cum_a - cj));
        const float lb = state ? la : expf((float)(cum_b - cj));
        float va = s[i + e] * la * d;
        float vb = s[i + 2 + e] * lb * d;
        if (t == t_last) {        // a select, never a product with the mask
          va = j <= last_a ? va : 0.f;
          vb = j <= last_b ? vb : 0.f;
        }
        s[i + e] = va;
        s[i + 2 + e] = vb;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(y);
    hopper::fence_operands(vh);
    hopper::fence_operands(vl);
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2)
      split(s[i], s[i + 1], vh[i / 2], vl[i / 2]);
  }
  // the last tile's products
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  hopper::wgmma_fence();
  issue_times_x<P>(y, vh, x_stage(t_last));
  issue_times_x<P>(y, vl, x_stage(t_last));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(y);

  if (state) {
    // y[4i + e] is state row n0 + r + 8 (e / 2), column 8 i + 2 quad + e % 2
    float* out = p.st + k.bi * p.st_sb + k.hi * p.st_sh +
                 (int64_t)blockIdx.y * p.st_sl + n0;
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      const int col = 8 * (i / 4) + 2 * quad;
      if (r < L::NS) {
        out[col * N + r] = y[i];
        out[(col + 1) * N + r] = y[i + 1];
      }
      if (r + 8 < L::NS) {
        out[col * N + r + 8] = y[i + 2];
        out[(col + 1) * N + r + 8] = y[i + 3];
      }
    }
    return;
  }
  T* yp = static_cast<T*>(p.y) + k.bi * p.y_sb + k.hi * p.y_sh +
          k.row0 * p.y_ss;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int col = 8 * (i / 4) + 2 * quad;
    if (i0 + r < q)
      *reinterpret_cast<uint32_t*>(yp + (i0 + r) * p.y_ss + col) =
          hopper::pack_bf16(y[i], y[i + 1]);
    if (i0 + r + 8 < q)
      *reinterpret_cast<uint32_t*>(yp + (i0 + r + 8) * p.y_ss + col) =
          hopper::pack_bf16(y[i + 2], y[i + 3]);
  }
}

// grid (B * H, S / Q, STATE_BLOCKS + row tiles): z < STATE_BLOCKS is a
// state block, then row tiles from the last (longest) to the first.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, Tiles<P, N>::BLOCKS)
ssd_chunk_bf16(const Params p) {
  using L = Tiles<P, N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  Block k;
  k.s_c = (base + 1023) & ~1023u;
  k.s_b = k.s_c + L::C_BYTES;
  k.s_x = k.s_b + L::C_BYTES;
  const int padded = p.row_tiles * kTile;
  k.cum = reinterpret_cast<double*>(smem_raw + (k.s_x + 2 * L::X_BYTES -
                                                base));
  k.sdt = reinterpret_cast<float*>(k.cum + padded);
  k.bi = blockIdx.x / p.heads;
  k.hi = blockIdx.x % p.heads;
  k.row0 = (int64_t)blockIdx.y * p.chunk;
  k.x = static_cast<const T*>(p.x) + k.bi * p.x_sb + k.hi * p.x_sh +
        k.row0 * p.x_ss;
  k.b = static_cast<const T*>(p.b) + k.bi * p.b_sb + k.hi * p.b_sh +
        k.row0 * p.b_ss;
  k.c = static_cast<const T*>(p.c) + k.bi * p.c_sb + k.hi * p.c_sh +
        k.row0 * p.c_ss;
  k.work = static_cast<const uint8_t*>(p.work) +
           ((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * work_bytes(padded);
  const int z = blockIdx.z;
  if (z < L::STATE_BLOCKS)
    rows_block<P, N>(p, k, 0, z * L::NS);
  else
    rows_block<P, N>(p, k, p.row_tiles - 1 - (z - L::STATE_BLOCKS), -1);
}

template <int P, int N>
cudaError_t launch(const Params& p, int bh, int chunks, cudaStream_t stream) {
  using L = Tiles<P, N>;
  static bool done[64] = {};
  cudaError_t err = allow_smem(ssd_chunk_bf16<P, N>,
                               L::smem(kMaxChunk), done);
  if (err != cudaSuccess) return err;
  ssd_chunk_cum<<<dim3(bh, chunks), kRuns, sizeof(float) * p.chunk,
                  stream>>>(p);
  const dim3 grid(bh, chunks, L::STATE_BLOCKS + p.row_tiles);
  ssd_chunk_bf16<P, N><<<grid, kThreads, L::smem(p.row_tiles * kTile),
                         stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// fp32: CUDA cores

namespace f32 {

constexpr int kThreads = 256;
static_assert(kThreads == kRuns, "chunk_cumsum takes one run a thread");

template <int P, int N>
constexpr size_t smem_bytes(int chunk) {
  // cum (double) + run totals (double) + dt, then the tiles
  return sizeof(double) * (size_t)(chunk + kRuns) +
         sizeof(float) * (size_t)chunk +
         sizeof(float) * (size_t)(2 * kTile * (N + 1) + kTile * (P + 1) +
                                  kTile * (kTile + 1));
}

// rows [row0, row0 + kTile) of a [Q, W] slice into dst [kTile][W + 1],
// times scale[row] when scale is given; zero from row `rows` on.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int row0, int rows,
                                          const float* scale) {
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W, k = idx % W;
    float v = 0.f;
    if (r < rows) {
      v = src[(int64_t)(row0 + r) * stride + k];
      if (scale != nullptr) v *= scale[row0 + r];
    }
    dst[r * (W + 1) + k] = v;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_f32(const Params p) {
  constexpr int LN = N + 1, LP = P + 1, LS = kTile + 1;
  extern __shared__ double smem_d[];
  double* cum = smem_d;                        // [chunk]
  double* runs = cum + p.chunk;                // [kRuns]
  float* sdt = reinterpret_cast<float*>(runs + kRuns);   // [chunk]
  float* s_a = sdt + p.chunk;                  // [kTile][LN]: C, or B*decay
  float* s_b = s_a + kTile * LN;               // [kTile][LN]: B
  float* s_x = s_b + kTile * LN;               // [kTile][LP]: x * dt
  float* s_s = s_x + kTile * LP;               // [kTile][LS]: scores * L

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q = p.chunk;
  const int bi = blockIdx.z / p.heads, hi = blockIdx.z % p.heads;
  const int64_t row0 = (int64_t)blockIdx.y * q;   // the chunk's first row
  const float* xp = static_cast<const float*>(p.x) + bi * p.x_sb +
                    hi * p.x_sh + row0 * p.x_ss;
  const float* dtp = p.dt + bi * p.dt_sb + hi * p.dt_sh + row0 * p.dt_ss;
  const float* bp = static_cast<const float*>(p.b) + bi * p.b_sb +
                    hi * p.b_sh + row0 * p.b_ss;
  const float* cp = static_cast<const float*>(p.c) + bi * p.c_sb +
                    hi * p.c_sh + row0 * p.c_ss;
  const float a = p.a[bi * p.a_sb + hi * p.a_sh];

  for (int j = threadIdx.x; j < q; j += kThreads) sdt[j] = dtp[j * p.dt_ss];
  __syncthreads();
  chunk_cumsum(cum, runs, sdt, a, q);

  if ((int)blockIdx.x == p.row_tiles) {
    // ---- the chunk's state: st[p][n] = sum_j xdt[j][p] * B[j][n] decay[j]
    constexpr int RP = P / 16, CN = N / 16;
    float acc[RP][CN];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    const double last = cum[q - 1];
    // the decay of each row, in place of dt once x * dt is staged
    for (int j0 = 0; j0 < q; j0 += kTile) {
      const int rows = min(kTile, q - j0);
      __syncthreads();              // the previous tile is consumed
      load_tile<P>(s_x, xp, p.x_ss, j0, rows, sdt);
      __syncthreads();              // sdt of this tile is read
      for (int r = threadIdx.x; r < rows; r += kThreads)
        sdt[j0 + r] = expf((float)(last - cum[j0 + r]));
      __syncthreads();
      load_tile<N>(s_a, bp, p.b_ss, j0, rows, sdt);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float xr[RP], br[CN];
#pragma unroll
        for (int i = 0; i < RP; ++i) xr[i] = s_x[k * LP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < CN; ++j) br[j] = s_a[k * LN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(xr[i], br[j], acc[i][j]);
      }
    }
    float* out = p.st + bi * p.st_sb + hi * p.st_sh +
                 (int64_t)blockIdx.y * p.st_sl;
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        out[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
    return;
  }

  // ---- y for query rows [i0, i0 + rows) of the chunk
  constexpr int RQ = kTile / 16, CK = kTile / 16, CP = P / 16;
  const int i0 = blockIdx.x * kTile;
  const int rows = min(kTile, q - i0);
  load_tile<N>(s_a, cp, p.c_ss, i0, rows, nullptr);
  float acc[RQ][CP];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < i0 + rows; j0 += kTile) {   // key tiles up to the
    const int keys = min(kTile, q - j0);             // diagonal
    __syncthreads();                // the previous tile is consumed
    load_tile<N>(s_b, bp, p.b_ss, j0, keys, nullptr);
    load_tile<P>(s_x, xp, p.x_ss, j0, keys, sdt);
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float cr[RQ], br[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) cr[i] = s_a[(ty + 16 * i) * LN + k];
#pragma unroll
      for (int j = 0; j < CK; ++j) br[j] = s_b[(tx + 16 * j) * LN + k];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(cr[i], br[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = i0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = j0 + tx + 16 * j;
        // select, never multiply by the mask: exp above the diagonal may
        // be inf
        float v = 0.f;
        if (kj <= qi && qi < q)
          v = s[i][j] * expf((float)(cum[qi] - cum[kj]));
        s_s[(ty + 16 * i) * LS + tx + 16 * j] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      float sr[RQ], xr[CP];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sr[i] = s_s[(ty + 16 * i) * LS + k];
#pragma unroll
      for (int j = 0; j < CP; ++j) xr[j] = s_x[k * LP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) acc[i][j] = fmaf(sr[i], xr[j], acc[i][j]);
    }
  }
  float* yp = static_cast<float*>(p.y) + bi * p.y_sb + hi * p.y_sh +
              row0 * p.y_ss;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = i0 + ty + 16 * i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < CP; ++j) yp[r * p.y_ss + tx + 16 * j] = acc[i][j];
  }
}

template <int P, int N>
cudaError_t launch(const Params& p, int bh, int chunks, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ssd_chunk_f32<P, N>,
                               smem_bytes<P, N>(kMaxChunk), done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.row_tiles + 1, chunks, bh);
  ssd_chunk_f32<P, N><<<grid, kThreads, smem_bytes<P, N>(p.chunk),
                        stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

template <int P, int N>
cudaError_t launch(const Params& p, int bh, int chunks, int dtype,
                   cudaStream_t s) {
  if (dtype == 0) return f32::launch<P, N>(p, bh, chunks, s);
  if (dtype == 1) return bf16::launch<P, N>(p, bh, chunks, s);
  return cudaErrorInvalidValue;
}

template <int P>
cudaError_t dispatch_n(const Params& p, int bh, int chunks, int n, int dtype,
                       cudaStream_t s) {
  switch (n) {
    case 16: return launch<P, 16>(p, bh, chunks, dtype, s);
    case 32: return launch<P, 32>(p, bh, chunks, dtype, s);
    case 64: return launch<P, 64>(p, bh, chunks, dtype, s);
    case 128: return launch<P, 128>(p, bh, chunks, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Params& p, int bh, int chunks, int pd, int n,
                     int dtype, cudaStream_t s) {
  switch (pd) {
    case 16: return dispatch_n<16>(p, bh, chunks, n, dtype, s);
    case 32: return dispatch_n<32>(p, bh, chunks, n, dtype, s);
    case 64: return dispatch_n<64>(p, bh, chunks, n, dtype, s);
    case 128: return dispatch_n<128>(p, bh, chunks, n, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 path's 16-byte loads need 16-byte aligned rows.
bool rows_aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         sh % 8 == 0 && ss % 8 == 0;
}

// ---------------------------------------------------------------------------
// The backward: `repro_ssd_chunk_bwd`
//
// Replaces no TPU kernel: the Pallas kernel has no backward.  It was added
// so that training runs the block on the card (the forward kernel under
// autograd, `kernels/ops.py`): before it, training ran the plain version
// under autograd, which writes several float32 [B, H, L, Q, Q] tensors a
// layer.  Given dy [Q, P] and dstates [P, N] of every (batch, head, chunk),
// with S = C B^T (shared by a group's heads), L the masked decay, M = S o L,
// xdt = x dt and w = exp(cum[Q-1] - cum) the decay of the states:
//
//   dxdt  = M^T dy + (B o w) dstates^T        dx = dxdt dt
//   dS    = sum_h (dy xdt^T) o L              dC = dS B,  dB = dS^T C
//   dB   += sum_h w o (xdt dstates)
//   dcum  = rowsum(dM o M) - colsum(dM o M) - g, dM = dy xdt^T,
//           g = w o rowsum(B o (xdt dstates)), dcum[Q-1] += sum g
//   d(dt a) = reverse cumsum of dcum; ddt = rowsum(dxdt o x) + d(dt a) a,
//   da = sum d(dt a) dt
//
// What bounds it on an H100: at mamba2-780m's train shape (B = 2, S = 4096,
// 48 heads, P = 64, N = 128, Q = 512) it must read x, dy (bf16, 50 MB
// each), dstates (f32, 25 MB), b, c, dt and write dx (50 MB), ddt, db, dc:
// ~188 MB, 0.056 ms at 3.35 TB/s.  Its products over the causal pairs
// i >= j are ~40 GFLOP (68 counting the whole Q x Q), 0.041 ms at 989
// TFLOP/s: the bound is the bytes, and the operations are close behind.
// As in the forward, no [Q, Q] tensor may reach memory, and the decay
// math (a float64 difference, its rounding and an expf per entry of every
// head's Q x Q) costs about as much on the CUDA cores as the products.
//
// The design answers with three passes after the forward's cum pre-pass
// (`ssd_chunk_cum`, so cum is the forward's to the bit), all over 64 x 64
// tiles of the causal pairs, in registers and shared memory:
//   dS blocks (`ssd_bwd_ds_*`), one per (batch, group, chunk, own 64-row
//   tile, kind, split of the group's heads): a dC block owns 64 query rows
//   i and walks the key tiles j <= i, a dB block owns 64 key rows j and
//   walks the query tiles i >= j.  For each tile it forms S once, then for
//   each head the 64 x 64 tile of dy x^T (or x dy^T), times dt and L,
//   summed over the heads in registers: that is dS's tile, with no head
//   sum ever in memory.  dS then goes to the tensor cores once per tile
//   (dC += dS B_j, dB += dS^T C_i).  The rows of dM o M are summed on the
//   way, each block's own rows only, so dcum needs no atomic.  A dB block
//   adds the states' term head by head at the end.  The heads of a group
//   are split over up to MAX_SPLIT_HEADS-head blocks to fill the card;
//   each split writes its own partial dB, dC, added in order afterwards;
//   split 0's dC starts from the caller's `dc_extra` where it gives one
//   (c's read-out term from steps 3 and 4, csrc/ssd_state.cu).
//   dx blocks (`ssd_bwd_dx_*`), one per (batch, head, chunk, key tile j):
//   (B_j dstates^T) first, then over the query tiles i >= j, S^T = B_j
//   C_i^T, times L, and dxdt += (S^T o L) dy_i, with g and rowsum(dxdt o
//   x) on the way.  A finishing pass (`ssd_bwd_finish`) per (batch, head,
//   chunk) sums dcum's four parts and, where the caller gives them, the
//   gradients that steps 3 and 4 of the chunked SSD send to their own
//   cumsum of dt a (`dcum_extra`, csrc/ssd_state.cu), takes the reverse
//   cumsum of the total in float64 and writes ddt and da's chunk sums.
// Every sum over heads, tiles or rows runs in a fixed order: the same
// inputs give bit-equal gradients.  The masks are selects before the exp.
//
// bf16: one warpgroup a block, every product a warpgroup MMA (f32
// accumulators) on operands from shared memory (cp.async, the forward's
// swizzled tiles), the float32 ones (dS, S^T o L, dstates, x dt w) in two
// bf16 parts as in the forward, as A operands in registers.
// fp32: the same passes on the CUDA cores (16 x 16 threads a block), the
// products as float32 FMAs over padded shared-memory tiles.

// rows' four parts, float64: the rows and columns of dM o M summed (in
// float64, as the plain version sums them, so that their equal terms
// cancel), the states' decay term g, and x's share of ddt
enum { kPlus = 0, kMinus = 1, kDecay = 2, kDdtX = 3 };

struct BwdParams {
  Params f;          // x, dt, a, b, c (their strides; b, c by group), work
  const void* dy;
  const float* dst;
  void* dx;
  float* ddt;
  float* da;         // [B, H, L]: d(dt a) dt summed over each chunk
  float* part;       // [2, splits, B, G, S, N]: dB, then dC, each split's
  double* rows;      // [4, B, H, S]: kPlus, kMinus, kDecay, kDdtX
  const float* dcum_extra;   // [B, H, S] added to dcum, or null
  const float* dc_extra;     // [B, G, S, N] added to split 0's dC, or null
  int batch, groups, seqlen, splits, ndim;
  int64_t dy_sb, dy_sh, dy_ss;
  int64_t dst_sb, dst_sh, dst_sl;
  int64_t dx_sb, dx_sh, dx_ss;
  int64_t ddt_sb, ddt_sh, ddt_ss;
};

// The work buffer of (batch * head bh, chunk l): cum (double) and dt.
__device__ __forceinline__ const uint8_t* work_of(const BwdParams& p, int bh,
                                                  int l) {
  const int padded = p.f.row_tiles * kTile;
  return static_cast<const uint8_t*>(p.f.work) +
         ((int64_t)bh * (p.seqlen / p.f.chunk) + l) * 12 * (int64_t)padded;
}

// rows' part `kind` of (batch * head bh), from the chunk's first row row0
__device__ __forceinline__ double* rows_of(const BwdParams& p, int kind,
                                           int bh, int64_t row0) {
  return p.rows + ((int64_t)kind * p.batch * p.f.heads + bh) * p.seqlen +
         row0;
}

// part's [S, N] slice of (kind, split, batch, group)
__device__ __forceinline__ float* part_of(const BwdParams& p, int kind,
                                          int split, int bi, int g) {
  return p.part + ((((int64_t)kind * p.splits + split) * p.batch + bi) *
                       p.groups + g) * p.seqlen * p.ndim;
}

// dc_extra's [S, N] slice of (batch, group) where a block writes split 0's
// dC and the caller gives the term, else null
__device__ __forceinline__ const float* extra_of(const BwdParams& p, int kind,
                                                 int split, int bi, int g) {
  if (kind != 1 || split != 0 || p.dc_extra == nullptr) return nullptr;
  return p.dc_extra + ((int64_t)bi * p.groups + g) * p.seqlen * p.ndim;
}

// A dS block's share, from blockIdx: grid (B * G, chunks, 2 * row_tiles *
// splits).  kind 0 (dB): own key tile j, query tiles own .. last; kind 1
// (dC): own query tile i, key tiles 0 .. own; the kinds interleaved and the
// longest walks first.  Heads [h_lo, h_hi) of group g.
struct DsBlock {
  int bi, g, l, kind, own, first, last, h_lo, h_hi, split;
  __device__ explicit DsBlock(const BwdParams& p) {
    const int t = p.f.row_tiles;
    bi = blockIdx.x / p.groups;
    g = blockIdx.x % p.groups;
    l = blockIdx.y;
    split = blockIdx.z % p.splits;
    const int kz = blockIdx.z / p.splits;
    kind = kz & 1;
    const int rank = kz >> 1;
    own = kind == 0 ? rank : t - 1 - rank;
    first = kind == 0 ? own : 0;
    last = kind == 0 ? t - 1 : own;
    const int hpg = p.f.heads / p.groups;
    h_lo = g * hpg + split * hpg / p.splits;
    h_hi = g * hpg + (split + 1) * hpg / p.splits;
  }
};

// Sums d(dt a) into ddt and da: per (batch * head, chunk), kRuns threads,
// each a run of rows summed from the chunk's end in float64, the runs'
// totals scanned from the last, then each run adds the total after it.
__global__ void __launch_bounds__(kRuns) ssd_bwd_finish(const BwdParams p) {
  __shared__ double runs[kRuns];
  const int q = p.f.chunk, bh = blockIdx.x, l = blockIdx.y;
  const int bi = bh / p.f.heads, hi = bh % p.f.heads;
  const int64_t row0 = (int64_t)l * q;
  const double* plus = rows_of(p, kPlus, bh, row0);
  const double* minus = rows_of(p, kMinus, bh, row0);
  const double* dec = rows_of(p, kDecay, bh, row0);
  const double* ddtx = rows_of(p, kDdtX, bh, row0);
  const float* extra = p.dcum_extra == nullptr
                           ? nullptr
                           : p.dcum_extra + (int64_t)bh * p.seqlen + row0;
  const float* dtp = p.f.dt + bi * p.f.dt_sb + hi * p.f.dt_sh + row0 * p.f.dt_ss;
  float* ddt = p.ddt + bi * p.ddt_sb + hi * p.ddt_sh + row0 * p.ddt_ss;
  const float a = p.f.a[bi * p.f.a_sb + hi * p.f.a_sh];
  const int t = threadIdx.x;
  const int per = (q + kRuns - 1) / kRuns;
  const int lo = min(t * per, q), hi_row = min(lo + per, q);

  // the states' decay term's total goes to dcum[q - 1]
  double s = 0.0;
  for (int j = lo; j < hi_row; ++j) s += dec[j];
  runs[t] = s;
  __syncthreads();
  for (int half = kRuns / 2; half > 0; half >>= 1) {
    if (t < half) runs[t] += runs[t + half];
    __syncthreads();
  }
  const double dec_total = runs[0];
  __syncthreads();

  auto dcum = [&](int j) {
    return plus[j] - minus[j] - dec[j] + (j == q - 1 ? dec_total : 0.0) +
           (extra != nullptr ? (double)extra[j] : 0.0);
  };
  s = 0.0;
  for (int j = hi_row - 1; j >= lo; --j) s += dcum(j);
  runs[t] = s;
  __syncthreads();
  for (int off = 1; off < kRuns; off <<= 1) {   // inclusive scan from the end
    const double v = t + off < kRuns ? runs[t + off] : 0.0;
    __syncthreads();
    runs[t] += v;
    __syncthreads();
  }
  double after = t + 1 < kRuns ? runs[t + 1] : 0.0;
  __syncthreads();
  double da = 0.0;
  for (int j = hi_row - 1; j >= lo; --j) {
    after += dcum(j);
    const float dda = (float)after;   // d(dt a), as autograd casts it
    const float dtj = dtp[j * p.f.dt_ss];
    ddt[j * p.ddt_ss] = (float)ddtx[j] + dda * a;
    da += (double)(dda * dtj);
  }
  runs[t] = da;
  __syncthreads();
  for (int half = kRuns / 2; half > 0; half >>= 1) {
    if (t < half) runs[t] += runs[t + half];
    __syncthreads();
  }
  if (t == 0) p.da[(int64_t)bh * gridDim.y + l] = (float)runs[0];
}

// ---------------------------------------------------------------------------
// bf16 backward: tensor cores

namespace bf16 {

template <int P, int N>
struct BwdTiles {
  static constexpr int N_BYTES = kTile * N * 2;    // a tile of B or C
  static constexpr int P_BYTES = kTile * P * 2;    // a tile of x or dy
  // dstates' [P, N] block in bf16, whole 1024-byte units
  static constexpr int DST_BYTES = (P * N * 2 + 1023) / 1024 * 1024;
  // dx blocks: B_j, C's one stage and dy's two stages (dstates' parts lie
  // over these three, one part at a time), then cum and dt of the chunk
  static constexpr int DX_TILES = 2 * N_BYTES + 2 * P_BYTES;
  static_assert(DST_BYTES <= N_BYTES + 2 * P_BYTES, "dstates' tile");
  static constexpr size_t dx_smem(int padded) {
    return 1024 + DX_TILES + 12 * (size_t)padded;
  }
  // dS blocks: the own tile of B or C, the other side's two stages, the
  // two stages of the own and other rows of x or dy (dstates' two parts
  // lie over these four), then per stage cum of the own and other rows and
  // dt of the key rows
  static constexpr int DS_TILES = 3 * N_BYTES + 4 * P_BYTES;
  static_assert(2 * DST_BYTES <= 4 * P_BYTES, "dstates' two tiles");
  static constexpr int DS_SMALL = 2 * (2 * 8 * kTile + 4 * kTile);
  static constexpr size_t ds_smem() { return 1024 + DS_TILES + DS_SMALL; }
  static constexpr int DX_BLOCKS = P >= 128 ? 1 : 2;
};

// D[64 x NB] (+)= A Bt^T over K = KD: A a 64-row tile and Bt an NB-row
// tile, both K-major (rows of KD), as the forward's `issue_scores`.
template <int KD, int NB>
__device__ __forceinline__ void mma_nt(float (&d)[NB / 2], uint32_t a,
                                       uint32_t bt, bool accumulate) {
  constexpr int W = hopper::TileShape<KD>::W, CB = hopper::TileShape<KD>::CB;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t col = (kk * 16) % CB * 2, blk = (kk * 16) / CB;
    hopper::Wgmma<NB>::template ss<0>(
        d, hopper::smem_desc<W>(a + blk * (kTile * W) + col, 16, 8 * W),
        hopper::smem_desc<W>(bt + blk * (NB * W) + col, 16, 8 * W),
        accumulate || kk > 0);
  }
}

// D[64 x NB] += A[64 x K] B[K x NB]: A from registers (K / 16 steps of
// four bf16 pairs), B a tile of K rows, MN-major, as `issue_times_x`.
template <int NB, int K>
__device__ __forceinline__ void mma_rn(float (&d)[NB / 2],
                                       const uint32_t (&a)[K / 4],
                                       uint32_t b) {
  constexpr int W = hopper::TileShape<NB>::W;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    hopper::Wgmma<NB>::template rs<1>(
        d, ak, hopper::smem_desc<W>(b + kk * 16 * W, K * W, 8 * W), 1);
  }
}

// dstates' [P, N] block into the tile at `tile` as P rows of N (a B or C
// tile's layout): part 0 its bf16 rounding, 1 the rounded remainder.
// raw: the generic address of shared-memory address 0.
template <int P, int N>
__device__ __forceinline__ void store_dst(uint8_t* raw, uint32_t tile,
                                          const float* src, int part) {
  using Load = hopper::TileLoader<N, kThreads>;
  for (int i = threadIdx.x; i < P * (N / 8); i += kThreads) {
    const int r = i / (N / 8), ch = i % (N / 8);
    const float4 v0 = *reinterpret_cast<const float4*>(src + r * N + 8 * ch);
    const float4 v1 =
        *reinterpret_cast<const float4*>(src + r * N + 8 * ch + 4);
    const float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split(f[2 * e], f[2 * e + 1], hi, lo);
      w[e] = part == 0 ? hi : lo;
    }
    *reinterpret_cast<uint4*>(raw + tile + Load::template offset<P>(r, ch)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// bytes [0, n) of src into shared memory at dst by 16-byte cp.async
__device__ __forceinline__ void cp_bytes(uint32_t dst, const uint8_t* src,
                                         int n) {
  for (int i = 16 * threadIdx.x; i < n; i += 16 * kThreads)
    hopper::cp_async_16(dst + i, src + i, 16);
}

// the bf16 pair at (row, col) of a [S, W] slice as floats; zero past the
// chunk (row >= q)
__device__ __forceinline__ float2 pair_at(const T* src, int64_t stride,
                                          int row, int col, int q) {
  if (row >= q) return make_float2(0.f, 0.f);
  const uint32_t v =
      *reinterpret_cast<const uint32_t*>(src + row * stride + col);
  return make_float2(hopper::bf16_lo(v), hopper::bf16_hi(v));
}

// sums over the four threads of a quad (the threads of one row)
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dx blocks: grid (B * H, chunks, row tiles), key tile j0 = 64 z (the
// longest walk first).  dxdt[j] = w[j] (B_j dstates^T) + sum_{i >= j}
// (S^T o L)[j, i] dy[i]; dx = dxdt dt; rows: kDecay (g) and kDdtX.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, BwdTiles<P, N>::DX_BLOCKS)
ssd_bwd_dx_bf16(const BwdParams p) {
  using L = BwdTiles<P, N>;
  constexpr int NO = P / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  uint8_t* raw = smem_raw - base;          // shared address 0, generic
  const uint32_t s_b = (base + 1023) & ~1023u;
  const uint32_t s_c = s_b + L::N_BYTES;
  const uint32_t s_dy = s_c + L::N_BYTES;
  const int padded = p.f.row_tiles * kTile;
  double* cum = reinterpret_cast<double*>(raw + s_dy + 2 * L::P_BYTES);
  float* sdt = reinterpret_cast<float*>(cum + padded);
  auto dy_stage = [&](int t) { return s_dy + (uint32_t)(t & 1) * L::P_BYTES; };

  const int q = p.f.chunk, bh = blockIdx.x, l = blockIdx.y;
  const int bi = bh / p.f.heads, hi = bh % p.f.heads;
  const int g = hi / (p.f.heads / p.groups);
  const int jt = blockIdx.z, j0 = jt * kTile;
  const int64_t row0 = (int64_t)l * q;
  const T* x = static_cast<const T*>(p.f.x) + bi * p.f.x_sb + hi * p.f.x_sh +
               row0 * p.f.x_ss;
  const T* dy = static_cast<const T*>(p.dy) + bi * p.dy_sb + hi * p.dy_sh +
                row0 * p.dy_ss;
  const T* bp = static_cast<const T*>(p.f.b) + bi * p.f.b_sb +
                g * p.f.b_sh + row0 * p.f.b_ss;
  const T* cp = static_cast<const T*>(p.f.c) + bi * p.f.c_sb +
                g * p.f.c_sh + row0 * p.f.c_ss;
  const float* dst = p.dst + bi * p.dst_sb + hi * p.dst_sh + l * p.dst_sl;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r = 16 * warp + lane / 4;        // this thread's rows r, r + 8
  const int ja = j0 + r, jb = j0 + r + 8;
  const hopper::TileLoader<N, kThreads> lc(tid);
  const hopper::TileLoader<P, kThreads> lp(tid);

  lc.template load<kTile>(s_b, bp, p.f.b_ss, j0, q);
  cp_bytes(hopper::smem_addr(cum), work_of(p, bh, l), 12 * padded);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();

  // (B_j dstates^T)[j, p], dstates in two bf16 parts, one at a time over
  // C's stage and dy's
  float t[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) t[i] = 0.f;
  for (int part = 0; part < 2; ++part) {
    store_dst<P, N>(raw, s_c, dst, part);
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::fence_operands(t);
    hopper::wgmma_fence();
    mma_nt<N, P>(t, s_b, s_c, part > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(t);
    __syncthreads();          // every warp's product is done with the tile
  }
  lc.template load<kTile>(s_c, cp, p.f.c_ss, j0, q);
  hopper::cp_async_commit();

  // w[j] (B_j dstates^T) starts dxdt; g[j] = w dt sum_p x t
  const double last = cum[q - 1];
  const float wa = ja < q ? expf((float)(last - cum[ja])) : 0.f;
  const float wb = jb < q ? expf((float)(last - cum[jb])) : 0.f;
  float acc[NO];
  float ga = 0.f, gb = 0.f;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int col = 8 * (i / 4) + 2 * quad;
    const float2 xa = pair_at(x, p.f.x_ss, ja, col, q);
    const float2 xb = pair_at(x, p.f.x_ss, jb, col, q);
    ga += xa.x * t[i] + xa.y * t[i + 1];
    gb += xb.x * t[i + 2] + xb.y * t[i + 3];
    acc[i] = wa * t[i];
    acc[i + 1] = wa * t[i + 1];
    acc[i + 2] = wb * t[i + 2];
    acc[i + 3] = wb * t[i + 3];
  }
  ga = quad_sum(ga);
  gb = quad_sum(gb);
  double* rows_dec = rows_of(p, kDecay, bh, row0);
  if (quad == 0) {
    if (ja < q) rows_dec[ja] = wa * sdt[ja] * ga;
    if (jb < q) rows_dec[jb] = wb * sdt[jb] * gb;
  }

  // Software pipeline, as the forward's: iteration t issues S^T[t] = B_j
  // C[t]^T and dxdt += v[t-1] dy[t-1] together, then forms v[t] = S^T[t] o
  // L from the fragments.  dy[t] is loaded from the top of iteration t;
  // C[t+1] as soon as every warp's S^T[t] is done.
  const int t_first = jt, t_last = p.f.row_tiles - 1;
  const double cum_a = cum[ja], cum_b = cum[jb];
  float s[kTile / 2];
  uint32_t vh[16], vl[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) vh[i] = vl[i] = 0;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) s[i] = 0.f;
  for (int it = t_first; it <= t_last; ++it) {
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();
    lp.template load<kTile>(dy_stage(it), dy, p.dy_ss, it * kTile, q);
    hopper::cp_async_commit();

    hopper::fence_operands(s);
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
    mma_nt<N, kTile>(s, s_b, s_c, false);
    hopper::wgmma_commit();
    if (it > t_first) {
      mma_rn<P, kTile>(acc, vh, dy_stage(it - 1));
      mma_rn<P, kTile>(acc, vl, dy_stage(it - 1));
    }
    hopper::wgmma_commit();
    if (it > t_first)
      hopper::wgmma_wait<1>();
    else
      hopper::wgmma_wait<0>();
    hopper::fence_operands(s);
    if (it < t_last) {
      __syncthreads();            // every warp's S^T[it] is done: C is free
      lc.template load<kTile>(s_c, cp, p.f.c_ss, (it + 1) * kTile, q);
      hopper::cp_async_commit();
    }
    // s[4m + e] is row r + 8 (e / 2), query column 8 m + 2 quad + e % 2
    const int i0 = it * kTile;
#pragma unroll
    for (int k = 0; k < kTile / 2; k += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + 2 * (k + quad) + e;
        const double ci = cum[i];
        const bool oka = i >= ja && i < q, okb = i >= jb && i < q;
        s[k + e] *= expf(oka ? (float)(ci - cum_a) : -INFINITY);
        s[k + 2 + e] *= expf(okb ? (float)(ci - cum_b) : -INFINITY);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    hopper::fence_operands(vh);
    hopper::fence_operands(vl);
#pragma unroll
    for (int i = 0; i < kTile / 2; i += 2)
      split(s[i], s[i + 1], vh[i / 2], vl[i / 2]);
  }
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  hopper::wgmma_fence();
  mma_rn<P, kTile>(acc, vh, dy_stage(t_last));
  mma_rn<P, kTile>(acc, vl, dy_stage(t_last));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(acc);

  // dx = dxdt dt; kDdtX = sum_p dxdt x
  T* dxp = static_cast<T*>(p.dx) + bi * p.dx_sb + hi * p.dx_sh +
           row0 * p.dx_ss;
  const float dta = sdt[ja], dtb = sdt[jb];
  float ea = 0.f, eb = 0.f;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int col = 8 * (i / 4) + 2 * quad;
    const float2 xa = pair_at(x, p.f.x_ss, ja, col, q);
    const float2 xb = pair_at(x, p.f.x_ss, jb, col, q);
    ea += acc[i] * xa.x + acc[i + 1] * xa.y;
    eb += acc[i + 2] * xb.x + acc[i + 3] * xb.y;
    if (ja < q)
      *reinterpret_cast<uint32_t*>(dxp + ja * p.dx_ss + col) =
          hopper::pack_bf16(acc[i] * dta, acc[i + 1] * dta);
    if (jb < q)
      *reinterpret_cast<uint32_t*>(dxp + jb * p.dx_ss + col) =
          hopper::pack_bf16(acc[i + 2] * dtb, acc[i + 3] * dtb);
  }
  ea = quad_sum(ea);
  eb = quad_sum(eb);
  double* rows_x = rows_of(p, kDdtX, bh, row0);
  if (quad == 0) {
    if (ja < q) rows_x[ja] = ea;
    if (jb < q) rows_x[jb] = eb;
  }
}

// dS blocks (see DsBlock): for each other tile, S (own rows against the
// other's) once, then per head D = U V^T (dB: x_h[j] dy_h[i]^T, dC: dy_h[i]
// x_h[j]^T) and w = D dt[j] L, summed over the heads into dS and, times S,
// over the tile's columns into the head's dcum rows (kMinus, kPlus); then
// dB += dS C_i or dC += dS B_j.  A dB block then adds sum_h (x_h dt_h w_h)
// dstates_h.  The sum goes to this split's part; split 0's dC adds
// dc_extra, the read-out's term of steps 3 and 4.
// DB: the block's kind is dB (else dC), a template argument so that each
// kind's loop is compiled without the other's selects.
template <int P, int N, bool DB>
__device__ __forceinline__ void ds_block(const BwdParams& p,
                                         const DsBlock& blk) {
  using L = BwdTiles<P, N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  uint8_t* raw = smem_raw - base;
  const uint32_t s_own = (base + 1023) & ~1023u;
  const uint32_t s_oth = s_own + L::N_BYTES;              // two stages
  const uint32_t s_uv = s_oth + 2 * L::N_BYTES;            // U0 U1 V0 V1
  const uint32_t s_small = s_uv + 4 * L::P_BYTES;          // two stages
  auto u_stage = [&](int k) { return s_uv + (uint32_t)(k & 1) * L::P_BYTES; };
  auto v_stage = [&](int k) {
    return s_uv + (uint32_t)(2 + (k & 1)) * L::P_BYTES;
  };
  auto oth_stage = [&](int o) {
    return s_oth + (uint32_t)(o & 1) * L::N_BYTES;
  };
  // a stage's cum of the own rows, of the other rows, dt of the key rows
  auto small = [&](int k) { return s_small + (uint32_t)(k & 1) * 1280u; };

  const int q = p.f.chunk, padded = p.f.row_tiles * kTile;
  constexpr bool db = DB;
  const int own0 = blk.own * kTile;
  const int64_t row0 = (int64_t)blk.l * q;
  const T* bp = static_cast<const T*>(p.f.b) + blk.bi * p.f.b_sb +
                blk.g * p.f.b_sh + row0 * p.f.b_ss;
  const T* cp = static_cast<const T*>(p.f.c) + blk.bi * p.f.c_sb +
                blk.g * p.f.c_sh + row0 * p.f.c_ss;
  const T* own_bc = db ? bp : cp;              // B_j or C_i
  const T* oth_bc = db ? cp : bp;
  const int64_t own_ss = db ? p.f.b_ss : p.f.c_ss;
  const int64_t oth_ss = db ? p.f.c_ss : p.f.b_ss;
  auto x_of = [&](int h) {
    return static_cast<const T*>(p.f.x) + blk.bi * p.f.x_sb + h * p.f.x_sh +
           row0 * p.f.x_ss;
  };
  auto dy_of = [&](int h) {
    return static_cast<const T*>(p.dy) + blk.bi * p.dy_sb + h * p.dy_sh +
           row0 * p.dy_ss;
  };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r = 16 * warp + lane / 4;        // this thread's rows r, r + 8
  const hopper::TileLoader<N, kThreads> lc(tid);
  const hopper::TileLoader<P, kThreads> lp(tid);
  const int nh = blk.h_hi - blk.h_lo;
  const int steps = (blk.last - blk.first + 1) * nh;

  // step k: other tile o = first + k / nh, head h_lo + k % nh
  auto load_step = [&](int k) {
    const int o = blk.first + k / nh, h = blk.h_lo + k % nh;
    const int oth0 = o * kTile, j0 = db ? own0 : oth0;
    const T* u = db ? x_of(h) : dy_of(h);
    const T* v = db ? dy_of(h) : x_of(h);
    lp.template load<kTile>(u_stage(k), u, db ? p.f.x_ss : p.dy_ss, own0, q);
    lp.template load<kTile>(v_stage(k), v, db ? p.dy_ss : p.f.x_ss, oth0, q);
    const uint8_t* w = work_of(p, blk.bi * p.f.heads + h, blk.l);
    cp_bytes(small(k), w + 8 * own0, 8 * kTile);
    cp_bytes(small(k) + 8 * kTile, w + 8 * oth0, 8 * kTile);
    cp_bytes(small(k) + 16 * kTile, w + 8 * padded + 4 * j0, 4 * kTile);
    if (k % nh == 0)
      lc.template load<kTile>(oth_stage(o), oth_bc, oth_ss, oth0, q);
  };

  lc.template load<kTile>(s_own, own_bc, own_ss, own0, q);
  load_step(0);
  hopper::cp_async_commit();

  float acc[N / 2], s[kTile / 2], ds[kTile / 2], d[kTile / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) s[i] = ds[i] = d[i] = 0.f;
  const int ra = own0 + r, rb = own0 + r + 8;     // own rows in the chunk
  for (int k = 0; k < steps; ++k) {
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (k + 1 < steps) {
      load_step(k + 1);
      hopper::cp_async_commit();
    }
    const int o = blk.first + k / nh, h = blk.h_lo + k % nh;
    const bool first_head = k % nh == 0, last_head = k % nh == nh - 1;
    // the head's dcum rows so far, read now so that the load's latency
    // hides behind the products (this thread wrote them itself)
    double* rows = rows_of(p, db ? kMinus : kPlus, blk.bi * p.f.heads + h,
                           row0);
    const bool add = quad == 0 && o != blk.first;
    const double prev_a = add && ra < q ? rows[ra] : 0.0;
    const double prev_b = add && rb < q ? rows[rb] : 0.0;
    hopper::fence_operands(d);
    hopper::fence_operands(s);
    hopper::wgmma_fence();
    if (first_head) mma_nt<N, kTile>(s, s_own, oth_stage(o), false);
    mma_nt<P, kTile>(d, u_stage(k), v_stage(k), false);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(d);
    hopper::fence_operands(s);

    // d[4m + e] is own row r + 8 (e / 2), other column 8 m + 2 quad + e % 2
    const double* cum_own =
        reinterpret_cast<const double*>(raw + small(k));
    const double* cum_oth = cum_own + kTile;
    const float* dtj = reinterpret_cast<const float*>(cum_oth + kTile);
    const double co_a = cum_own[r], co_b = cum_own[r + 8];
    const int oth0 = o * kTile;
    double rs_a = 0.0, rs_b = 0.0;     // summed as the plain version sums
#pragma unroll
    for (int m = 0; m < kTile / 2; m += 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 2 * (m + quad) + e, gt = oth0 + cc;
        const double ct = cum_oth[cc];
        // dB: own rows are keys j, columns queries i; dC the other way
        const bool oka = db ? gt >= ra && gt < q : gt <= ra && ra < q;
        const bool okb = db ? gt >= rb && gt < q : gt <= rb && rb < q;
        const float dta = db ? dtj[r] : dtj[cc];
        const float dtb = db ? dtj[r + 8] : dtj[cc];
        const float la = expf(oka ? (float)(db ? ct - co_a : co_a - ct)
                                  : -INFINITY);
        const float lb = expf(okb ? (float)(db ? ct - co_b : co_b - ct)
                                  : -INFINITY);
        const float wa = d[m + e] * dta * la;
        const float wb = d[m + 2 + e] * dtb * lb;
        ds[m + e] += wa;
        ds[m + 2 + e] += wb;
        rs_a += (double)(wa * s[m + e]);
        rs_b += (double)(wb * s[m + 2 + e]);
      }
    }
    rs_a = quad_sum(rs_a);
    rs_b = quad_sum(rs_b);
    if (quad == 0) {
      if (ra < q) rows[ra] = prev_a + rs_a;
      if (rb < q) rows[rb] = prev_b + rs_b;
    }
    if (last_head) {
      uint32_t vh[16], vl[16];
#pragma unroll
      for (int i = 0; i < kTile / 2; i += 2)
        split(ds[i], ds[i + 1], vh[i / 2], vl[i / 2]);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
      mma_rn<N, kTile>(acc, vh, oth_stage(o));
      mma_rn<N, kTile>(acc, vl, oth_stage(o));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      hopper::fence_operands(vh);
      hopper::fence_operands(vl);
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) ds[i] = 0.f;
    }
  }

  if (db) {
    // the states' term, head by head: (x_h dt_h w_h)[j, :] dstates_h with
    // both factors in two bf16 parts (the lo x lo product left out)
    const uint32_t s_hi = s_uv, s_lo = s_uv + L::DST_BYTES;
    for (int h = blk.h_lo; h < blk.h_hi; ++h) {
      __syncthreads();            // the tiles are free
      const float* dst = p.dst + blk.bi * p.dst_sb + h * p.dst_sh +
                         blk.l * p.dst_sl;
      store_dst<P, N>(raw, s_hi, dst, 0);
      store_dst<P, N>(raw, s_lo, dst, 1);
      hopper::fence_proxy_async();
      const uint8_t* w = work_of(p, blk.bi * p.f.heads + h, blk.l);
      const double* cumh = reinterpret_cast<const double*>(w);
      const float* dth = reinterpret_cast<const float*>(w + 8 * padded);
      const double lastc = cumh[q - 1];
      const float sa = ra < q ? dth[ra] * expf((float)(lastc - cumh[ra]))
                              : 0.f;
      const float sb = rb < q ? dth[rb] * expf((float)(lastc - cumh[rb]))
                              : 0.f;
      const T* xh = x_of(h);
      uint32_t ah[P / 4], al[P / 4];
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int row = jj % 2 ? rb : ra;
          const float sc = jj % 2 ? sb : sa;
          const float2 v = pair_at(xh, p.f.x_ss, row,
                                   16 * kk + 8 * (jj / 2) + 2 * quad, q);
          split(v.x * sc, v.y * sc, ah[4 * kk + jj], al[4 * kk + jj]);
        }
      }
      __syncthreads();
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
      mma_rn<N, P>(acc, ah, s_hi);
      mma_rn<N, P>(acc, al, s_hi);
      mma_rn<N, P>(acc, ah, s_lo);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      hopper::fence_operands(ah);
      hopper::fence_operands(al);
    }
  }

  // acc[4m + e] is own row r + 8 (e / 2), column 8 m + 2 quad + e % 2
  float* out = part_of(p, blk.kind, blk.split, blk.bi, blk.g) + row0 * N;
  const float* extra = extra_of(p, blk.kind, blk.split, blk.bi, blk.g);
  if (extra != nullptr) {
    extra += row0 * N;
#pragma unroll
    for (int m = 0; m < N / 2; m += 4) {
      const int col = 8 * (m / 4) + 2 * quad;
      if (ra < q) {
        const float2 e = *reinterpret_cast<const float2*>(
            extra + (int64_t)ra * N + col);
        acc[m] += e.x;
        acc[m + 1] += e.y;
      }
      if (rb < q) {
        const float2 e = *reinterpret_cast<const float2*>(
            extra + (int64_t)rb * N + col);
        acc[m + 2] += e.x;
        acc[m + 3] += e.y;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < N / 2; m += 4) {
    const int col = 8 * (m / 4) + 2 * quad;
    if (ra < q)
      *reinterpret_cast<float2*>(out + (int64_t)ra * N + col) =
          make_float2(acc[m], acc[m + 1]);
    if (rb < q)
      *reinterpret_cast<float2*>(out + (int64_t)rb * N + col) =
          make_float2(acc[m + 2], acc[m + 3]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_ds_bf16(const BwdParams p) {
  const DsBlock blk(p);
  if (blk.kind == 0)
    ds_block<P, N, true>(p, blk);
  else
    ds_block<P, N, false>(p, blk);
}

template <int P, int N>
cudaError_t launch_bwd(const BwdParams& p, int bh, int chunks,
                       cudaStream_t stream) {
  using L = BwdTiles<P, N>;
  static bool done_dx[64] = {}, done_ds[64] = {};
  cudaError_t err = allow_smem(ssd_bwd_dx_bf16<P, N>,
                               L::dx_smem(kMaxChunk), done_dx);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_ds_bf16<P, N>, L::ds_smem(), done_ds);
  if (err != cudaSuccess) return err;
  const int t = p.f.row_tiles;
  ssd_bwd_ds_bf16<P, N><<<dim3(p.batch * p.groups, chunks, 2 * t * p.splits),
                          kThreads, L::ds_smem(), stream>>>(p);
  ssd_bwd_dx_bf16<P, N><<<dim3(bh, chunks, t), kThreads,
                          L::dx_smem(t * kTile), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// fp32 backward: CUDA cores

namespace f32 {

constexpr int kSlab = 16;          // dstates rows (dS) or columns (dx) a pass

// half a warp's 16 threads (one row of the 16 x 16 grid) summed
template <typename V>
__device__ __forceinline__ V row_sum(V v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum (double) and dt of rows [0, padded) from the work buffer
__device__ __forceinline__ void load_work(double* cum, float* sdt,
                                          const uint8_t* w, int padded) {
  for (int j = threadIdx.x; j < padded; j += kThreads) {
    cum[j] = reinterpret_cast<const double*>(w)[j];
    sdt[j] = reinterpret_cast<const float*>(w + 8 * (size_t)padded)[j];
  }
}

template <int P, int N>
constexpr size_t dx_smem(int padded) {
  return 12 * (size_t)padded +
         sizeof(float) * (size_t)(2 * kTile * (N + 1) + kTile * (P + 1) +
                                  kTile * (kTile + 1) + P * (kSlab + 1));
}

// dx blocks, as the bf16 ones: thread (ty, tx) owns rows j0 + ty + 16 a of
// the key tile and columns tx + 16 k of P (or query columns tx + 16 k)
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dx_f32(const BwdParams p) {
  constexpr int LN = N + 1, LP = P + 1, LS = kTile + 1, CP = P / 16;
  extern __shared__ double smem_d[];
  const int padded = p.f.row_tiles * kTile;
  double* cum = smem_d;                                   // [padded]
  float* sdt = reinterpret_cast<float*>(cum + padded);    // [padded]
  float* s_b = sdt + padded;                              // [kTile][LN]
  float* s_c = s_b + kTile * LN;                          // [kTile][LN]
  float* s_dy = s_c + kTile * LN;                         // [kTile][LP]
  float* s_v = s_dy + kTile * LP;                         // [kTile][LS]
  float* s_st = s_v + kTile * LS;                         // [P][kSlab + 1]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q = p.f.chunk, bh = blockIdx.x, l = blockIdx.y;
  const int bi = bh / p.f.heads, hi = bh % p.f.heads;
  const int g = hi / (p.f.heads / p.groups);
  const int j0 = blockIdx.z * kTile;
  const int64_t row0 = (int64_t)l * q;
  const float* x = static_cast<const float*>(p.f.x) + bi * p.f.x_sb +
                   hi * p.f.x_sh + row0 * p.f.x_ss;
  const float* dy = static_cast<const float*>(p.dy) + bi * p.dy_sb +
                    hi * p.dy_sh + row0 * p.dy_ss;
  const float* bp = static_cast<const float*>(p.f.b) + bi * p.f.b_sb +
                    g * p.f.b_sh + row0 * p.f.b_ss;
  const float* cp = static_cast<const float*>(p.f.c) + bi * p.f.c_sb +
                    g * p.f.c_sh + row0 * p.f.c_ss;
  const float* dst = p.dst + bi * p.dst_sb + hi * p.dst_sh + l * p.dst_sl;

  load_work(cum, sdt, work_of(p, bh, l), padded);
  load_tile<N>(s_b, bp, p.f.b_ss, j0, min(kTile, q - j0), nullptr);
  // t = B_j dstates^T, kSlab columns of dstates at a time
  float t[4][CP];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < CP; ++k) t[a][k] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kSlab) {
    __syncthreads();
    for (int i = threadIdx.x; i < P * kSlab; i += kThreads)
      s_st[(i / kSlab) * (kSlab + 1) + i % kSlab] =
          dst[(i / kSlab) * N + n0 + i % kSlab];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kSlab; ++n) {
      float br[4], sr[CP];
#pragma unroll
      for (int a = 0; a < 4; ++a) br[a] = s_b[(ty + 16 * a) * LN + n0 + n];
#pragma unroll
      for (int k = 0; k < CP; ++k) sr[k] = s_st[(tx + 16 * k) * (kSlab + 1) + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < CP; ++k) t[a][k] = fmaf(br[a], sr[k], t[a][k]);
    }
  }
  // dxdt starts as w (B_j dstates^T); g = w dt sum_p x t
  const double last = cum[q - 1];
  float acc[4][CP];
  double* rows_dec = rows_of(p, kDecay, bh, row0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    const bool in = j < q;
    const float w = in ? expf((float)(last - cum[j])) : 0.f;
    float gp = 0.f;
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      gp += (in ? x[j * p.f.x_ss + tx + 16 * k] : 0.f) * t[a][k];
      acc[a][k] = w * t[a][k];
    }
    gp = row_sum(gp);
    if (tx == 0 && in) rows_dec[j] = w * sdt[j] * gp;
  }
  for (int i0 = j0; i0 < q; i0 += kTile) {      // query tiles from j's on
    const int rows = min(kTile, q - i0);
    __syncthreads();
    load_tile<N>(s_c, cp, p.f.c_ss, i0, rows, nullptr);
    load_tile<P>(s_dy, dy, p.dy_ss, i0, rows, nullptr);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[a][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float br[4], cr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) br[a] = s_b[(ty + 16 * a) * LN + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) cr[k] = s_c[(tx + 16 * k) * LN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[a][k] = fmaf(br[a], cr[k], s[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + tx + 16 * k;
        const bool ok = i >= j && i < q;
        s_v[(ty + 16 * a) * LS + tx + 16 * k] =
            s[a][k] * expf(ok ? (float)(cum[i] - cum[j]) : -INFINITY);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float vr[4], dr[CP];
#pragma unroll
      for (int a = 0; a < 4; ++a) vr[a] = s_v[(ty + 16 * a) * LS + i];
#pragma unroll
      for (int k = 0; k < CP; ++k) dr[k] = s_dy[i * LP + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[a][k] = fmaf(vr[a], dr[k], acc[a][k]);
    }
  }
  float* dxp = static_cast<float*>(p.dx) + bi * p.dx_sb + hi * p.dx_sh +
               row0 * p.dx_ss;
  double* rows_x = rows_of(p, kDdtX, bh, row0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    const bool in = j < q;
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      const int col = tx + 16 * k;
      if (in) {
        e += acc[a][k] * x[j * p.f.x_ss + col];
        dxp[j * p.dx_ss + col] = acc[a][k] * sdt[j];
      }
    }
    e = row_sum(e);
    if (tx == 0 && in) rows_x[j] = e;
  }
}

template <int P, int N>
constexpr size_t ds_smem() {
  return sizeof(double) * 2 * kTile +
         sizeof(float) * (size_t)(kTile + 2 * kTile * (N + 1) +
                                  2 * kTile * (P + 1) + kTile * (kTile + 1) +
                                  kSlab * (N + 1));
}

// dS blocks, as the bf16 ones (see DsBlock)
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_ds_f32(const BwdParams p) {
  constexpr int LN = N + 1, LP = P + 1, LS = kTile + 1, CN = N / 16;
  extern __shared__ double smem_d[];
  double* cum_own = smem_d;                               // [kTile]
  double* cum_oth = cum_own + kTile;                      // [kTile]
  float* dtj = reinterpret_cast<float*>(cum_oth + kTile); // [kTile]
  float* s_own = dtj + kTile;                             // [kTile][LN]
  float* s_oth = s_own + kTile * LN;                      // [kTile][LN]
  float* s_u = s_oth + kTile * LN;                        // [kTile][LP]
  float* s_v = s_u + kTile * LP;                          // [kTile][LP]
  float* s_ds = s_v + kTile * LP;                         // [kTile][LS]
  float* s_st = s_ds + kTile * LS;                        // [kSlab][LN]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const DsBlock blk(p);
  const int q = p.f.chunk, padded = p.f.row_tiles * kTile;
  const bool db = blk.kind == 0;
  const int own0 = blk.own * kTile;
  const int64_t row0 = (int64_t)blk.l * q;
  const float* bp = static_cast<const float*>(p.f.b) + blk.bi * p.f.b_sb +
                    blk.g * p.f.b_sh + row0 * p.f.b_ss;
  const float* cp = static_cast<const float*>(p.f.c) + blk.bi * p.f.c_sb +
                    blk.g * p.f.c_sh + row0 * p.f.c_ss;
  auto x_of = [&](int h) {
    return static_cast<const float*>(p.f.x) + blk.bi * p.f.x_sb +
           h * p.f.x_sh + row0 * p.f.x_ss;
  };
  auto dy_of = [&](int h) {
    return static_cast<const float*>(p.dy) + blk.bi * p.dy_sb +
           h * p.dy_sh + row0 * p.dy_ss;
  };
  const int own_rows = min(kTile, q - own0);
  load_tile<N>(s_own, db ? bp : cp, db ? p.f.b_ss : p.f.c_ss, own0, own_rows,
               nullptr);
  float acc[4][CN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < CN; ++k) acc[a][k] = 0.f;

  for (int o = blk.first; o <= blk.last; ++o) {
    const int oth0 = o * kTile, oth_rows = min(kTile, q - oth0);
    const int j0 = db ? own0 : oth0;
    __syncthreads();
    load_tile<N>(s_oth, db ? cp : bp, db ? p.f.c_ss : p.f.b_ss, oth0,
                 oth_rows, nullptr);
    __syncthreads();
    float s[4][4], ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[a][k] = ds[a][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float ur[4], vr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ur[a] = s_own[(ty + 16 * a) * LN + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) vr[k] = s_oth[(tx + 16 * k) * LN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[a][k] = fmaf(ur[a], vr[k], s[a][k]);
    }
    for (int h = blk.h_lo; h < blk.h_hi; ++h) {
      __syncthreads();
      load_tile<P>(s_u, db ? x_of(h) : dy_of(h), db ? p.f.x_ss : p.dy_ss,
                   own0, own_rows, nullptr);
      load_tile<P>(s_v, db ? dy_of(h) : x_of(h), db ? p.dy_ss : p.f.x_ss,
                   oth0, oth_rows, nullptr);
      const uint8_t* w = work_of(p, blk.bi * p.f.heads + h, blk.l);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        cum_own[i] = reinterpret_cast<const double*>(w)[own0 + i];
        cum_oth[i] = reinterpret_cast<const double*>(w)[oth0 + i];
        dtj[i] = reinterpret_cast<const float*>(w + 8 * (size_t)padded)[j0 + i];
      }
      __syncthreads();
      float d[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) d[a][k] = 0.f;
#pragma unroll 4
      for (int e = 0; e < P; ++e) {
        float ur[4], vr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ur[a] = s_u[(ty + 16 * a) * LP + e];
#pragma unroll
        for (int k = 0; k < 4; ++k) vr[k] = s_v[(tx + 16 * k) * LP + e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) d[a][k] = fmaf(ur[a], vr[k], d[a][k]);
      }
      double* rows = rows_of(p, db ? kMinus : kPlus,
                             blk.bi * p.f.heads + h, row0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ro = ty + 16 * a, go = own0 + ro;
        double rs = 0.0;                 // summed as the plain version sums
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int co = tx + 16 * k, gt = oth0 + co;
          const bool ok = db ? gt >= go && gt < q : gt <= go && go < q;
          const double diff = db ? cum_oth[co] - cum_own[ro]
                                 : cum_own[ro] - cum_oth[co];
          const float w = d[a][k] * dtj[db ? ro : co] *
                          expf(ok ? (float)diff : -INFINITY);
          ds[a][k] += w;
          rs += (double)(w * s[a][k]);
        }
        rs = row_sum(rs);
        if (tx == 0 && go < q)
          rows[go] = (o == blk.first ? 0.0 : rows[go]) + rs;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s_ds[(ty + 16 * a) * LS + tx + 16 * k] = ds[a][k];
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float dr[4], br[CN];
#pragma unroll
      for (int a = 0; a < 4; ++a) dr[a] = s_ds[(ty + 16 * a) * LS + i];
#pragma unroll
      for (int k = 0; k < CN; ++k) br[k] = s_oth[i * LN + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < CN; ++k) acc[a][k] = fmaf(dr[a], br[k], acc[a][k]);
    }
  }

  if (db) {
    // the states' term: (x_h dt_h w_h)[j, :] dstates_h, kSlab rows of
    // dstates at a time
    for (int h = blk.h_lo; h < blk.h_hi; ++h) {
      const uint8_t* w = work_of(p, blk.bi * p.f.heads + h, blk.l);
      const double* cumh = reinterpret_cast<const double*>(w);
      const float* dth = reinterpret_cast<const float*>(w + 8 * (size_t)padded);
      const double lastc = cumh[q - 1];
      __syncthreads();
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const int j = own0 + i;
        dtj[i] = j < q ? dth[j] * expf((float)(lastc - cumh[j])) : 0.f;
      }
      __syncthreads();
      load_tile<P>(s_u, x_of(h), p.f.x_ss, own0, own_rows, dtj - own0);
      const float* dst = p.dst + blk.bi * p.dst_sb + h * p.dst_sh +
                         blk.l * p.dst_sl;
      for (int e0 = 0; e0 < P; e0 += kSlab) {
        __syncthreads();
        for (int i = threadIdx.x; i < kSlab * N; i += kThreads)
          s_st[(i / N) * LN + i % N] = dst[(e0 + i / N) * N + i % N];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kSlab; ++e) {
          float ur[4], sr[CN];
#pragma unroll
          for (int a = 0; a < 4; ++a) ur[a] = s_u[(ty + 16 * a) * LP + e0 + e];
#pragma unroll
          for (int k = 0; k < CN; ++k) sr[k] = s_st[e * LN + tx + 16 * k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < CN; ++k)
              acc[a][k] = fmaf(ur[a], sr[k], acc[a][k]);
        }
      }
    }
  }

  float* out = part_of(p, blk.kind, blk.split, blk.bi, blk.g) + row0 * N;
  const float* extra = extra_of(p, blk.kind, blk.split, blk.bi, blk.g);
  if (extra != nullptr) extra += row0 * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int go = own0 + ty + 16 * a;
    if (go >= q) continue;
#pragma unroll
    for (int k = 0; k < CN; ++k) {
      const int64_t at = (int64_t)go * N + tx + 16 * k;
      out[at] = extra != nullptr ? acc[a][k] + extra[at] : acc[a][k];
    }
  }
}

template <int P, int N>
cudaError_t launch_bwd(const BwdParams& p, int bh, int chunks,
                       cudaStream_t stream) {
  static bool done_dx[64] = {}, done_ds[64] = {};
  cudaError_t err = allow_smem(ssd_bwd_dx_f32<P, N>,
                               dx_smem<P, N>(kMaxChunk), done_dx);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_ds_f32<P, N>, ds_smem<P, N>(), done_ds);
  if (err != cudaSuccess) return err;
  const int t = p.f.row_tiles;
  ssd_bwd_ds_f32<P, N><<<dim3(p.batch * p.groups, chunks, 2 * t * p.splits),
                         kThreads, ds_smem<P, N>(), stream>>>(p);
  ssd_bwd_dx_f32<P, N><<<dim3(bh, chunks, t), kThreads,
                         dx_smem<P, N>(t * kTile), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

template <int P, int N>
cudaError_t launch_bwd(const BwdParams& p, int dtype, cudaStream_t s) {
  const int bh = p.batch * p.f.heads, chunks = p.seqlen / p.f.chunk;
  // cum, as the forward sums it, into the work buffer
  bf16::ssd_chunk_cum<<<dim3(bh, chunks), kRuns, sizeof(float) * p.f.chunk,
                        s>>>(p.f);
  cudaError_t err = dtype == 1 ? bf16::launch_bwd<P, N>(p, bh, chunks, s)
                               : f32::launch_bwd<P, N>(p, bh, chunks, s);
  if (err != cudaSuccess) return err;
  ssd_bwd_finish<<<dim3(bh, chunks), kRuns, 0, s>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_bwd_n(const BwdParams& p, int n, int dtype,
                           cudaStream_t s) {
  switch (n) {
    case 16: return launch_bwd<P, 16>(p, dtype, s);
    case 32: return launch_bwd<P, 32>(p, dtype, s);
    case 64: return launch_bwd<P, 64>(p, dtype, s);
    case 128: return launch_bwd<P, 128>(p, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bwd(const BwdParams& p, int pd, int n, int dtype,
                         cudaStream_t s) {
  switch (pd) {
    case 16: return dispatch_bwd_n<16>(p, n, dtype, s);
    case 32: return dispatch_bwd_n<32>(p, n, dtype, s);
    case 64: return dispatch_bwd_n<64>(p, n, dtype, s);
    case 128: return dispatch_bwd_n<128>(p, n, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, b, c and y: 0 = float32, 1 = bfloat16; dt, a and states are
// float32.  seqlen is a multiple of chunk, 1 <= chunk <= 4096; p and n are
// 16, 32, 64 or 128.  Strides are in elements; the last dimension of x, b,
// c and y is contiguous and states are [P, N] contiguous per (b, h, chunk);
// for bfloat16, x, b, c and y start on 16 bytes and their strides are
// multiples of 8, and `work` is a 16-byte aligned scratch buffer of
// 12 * ceil(chunk / 64) * 64 bytes per (batch, head, chunk) (unused for
// float32).  Returns the CUDA error of the launch (0 on success).
int repro_ssd_chunk_fwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* states, void* work, int dtype, int batch,
    int heads,
    int seqlen, int chunk, int p, int n,
    int64_t x_sb, int64_t x_sh, int64_t x_ss,
    int64_t dt_sb, int64_t dt_sh, int64_t dt_ss,
    int64_t a_sb, int64_t a_sh,
    int64_t b_sb, int64_t b_sh, int64_t b_ss,
    int64_t c_sb, int64_t c_sh, int64_t c_ss,
    int64_t y_sb, int64_t y_sh, int64_t y_ss,
    int64_t st_sb, int64_t st_sh, int64_t st_sl, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (batch <= 0 || heads <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      seqlen <= 0 || seqlen % chunk != 0 || seqlen / chunk > 65535 ||
      (int64_t)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !(rows_aligned(x, x_sb, x_sh, x_ss) &&
                      rows_aligned(b, b_sb, b_sh, b_ss) &&
                      rows_aligned(c, c_sb, c_sh, c_ss) &&
                      rows_aligned(y, y_sb, y_sh, y_ss) &&
                      reinterpret_cast<uintptr_t>(work) % 16 == 0 &&
                      work != nullptr))
    return (int)cudaErrorMisalignedAddress;
  Params prm;
  prm.x = x; prm.dt = static_cast<const float*>(dt);
  prm.a = static_cast<const float*>(a); prm.b = b; prm.c = c; prm.y = y;
  prm.st = static_cast<float*>(states);
  prm.work = work;
  prm.heads = heads; prm.chunk = chunk;
  prm.row_tiles = (chunk + kTile - 1) / kTile;
  prm.x_sb = x_sb; prm.x_sh = x_sh; prm.x_ss = x_ss;
  prm.dt_sb = dt_sb; prm.dt_sh = dt_sh; prm.dt_ss = dt_ss;
  prm.a_sb = a_sb; prm.a_sh = a_sh;
  prm.b_sb = b_sb; prm.b_sh = b_sh; prm.b_ss = b_ss;
  prm.c_sb = c_sb; prm.c_sh = c_sh; prm.c_ss = c_ss;
  prm.y_sb = y_sb; prm.y_sh = y_sh; prm.y_ss = y_ss;
  prm.st_sb = st_sb; prm.st_sh = st_sh; prm.st_sl = st_sl;
  return (int)dispatch(prm, batch * heads, seqlen / chunk, p, n, dtype,
                       static_cast<cudaStream_t>(stream));
}

// dtype of x, b, c, dy and dx: 0 = float32, 1 = bfloat16; dt, a, dstates
// and ddt are float32.  b and c are [B, G, S, N] with G = 1 or heads (group
// stride b_sg, c_sg); splits in [1, heads / groups]; dstates' [P, N] blocks
// are contiguous and start on 16 bytes.  Scratch: da [B, H, S / chunk] and
// part [2, splits, B, G, S, N] float32, rows [4, B, H, S] float64, and
// `work`, 16-byte aligned, 12 * ceil(chunk / 64) * 64 bytes per (batch,
// head, chunk).  dcum, dense float32 [B, H, S] or null, is added to the
// gradient of cum before its reverse cumsum; dc_extra, dense float32 [B, G,
// S, N] or null, to split 0's dC.  Otherwise as
// repro_ssd_chunk_fwd.  Writes dx, ddt, da,
// part (each split's dB, then its dC); the caller adds the splits.  Returns
// the CUDA error of the launches (0 on success).
int repro_ssd_chunk_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* dy, const void* dstates, void* dx, void* ddt,
    void* da, void* part, void* rows, void* work, const void* dcum,
    const void* dc_extra, int dtype, int batch,
    int heads, int groups, int seqlen, int chunk, int p, int n, int splits,
    int64_t x_sb, int64_t x_sh, int64_t x_ss,
    int64_t dt_sb, int64_t dt_sh, int64_t dt_ss,
    int64_t a_sb, int64_t a_sh,
    int64_t b_sb, int64_t b_sg, int64_t b_ss,
    int64_t c_sb, int64_t c_sg, int64_t c_ss,
    int64_t dy_sb, int64_t dy_sh, int64_t dy_ss,
    int64_t dst_sb, int64_t dst_sh, int64_t dst_sl,
    int64_t dx_sb, int64_t dx_sh, int64_t dx_ss,
    int64_t ddt_sb, int64_t ddt_sh, int64_t ddt_ss, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (batch <= 0 || heads <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      seqlen <= 0 || seqlen % chunk != 0 || seqlen / chunk > 65535 ||
      (groups != 1 && groups != heads) || splits < 1 ||
      splits > heads / groups || (int64_t)batch * heads > 65535 ||
      work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dstates) % 16 != 0 || dst_sb % 4 != 0 ||
      dst_sh % 4 != 0 || dst_sl % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !(rows_aligned(x, x_sb, x_sh, x_ss) &&
                      rows_aligned(b, b_sb, b_sg, b_ss) &&
                      rows_aligned(c, c_sb, c_sg, c_ss) &&
                      rows_aligned(dy, dy_sb, dy_sh, dy_ss) &&
                      rows_aligned(dx, dx_sb, dx_sh, dx_ss)))
    return (int)cudaErrorMisalignedAddress;
  BwdParams prm;
  prm.f.x = x; prm.f.dt = static_cast<const float*>(dt);
  prm.f.a = static_cast<const float*>(a); prm.f.b = b; prm.f.c = c;
  prm.f.y = nullptr; prm.f.st = nullptr; prm.f.work = work;
  prm.f.heads = heads; prm.f.chunk = chunk;
  prm.f.row_tiles = (chunk + kTile - 1) / kTile;
  prm.f.x_sb = x_sb; prm.f.x_sh = x_sh; prm.f.x_ss = x_ss;
  prm.f.dt_sb = dt_sb; prm.f.dt_sh = dt_sh; prm.f.dt_ss = dt_ss;
  prm.f.a_sb = a_sb; prm.f.a_sh = a_sh;
  prm.f.b_sb = b_sb; prm.f.b_sh = b_sg; prm.f.b_ss = b_ss;
  prm.f.c_sb = c_sb; prm.f.c_sh = c_sg; prm.f.c_ss = c_ss;
  prm.f.y_sb = prm.f.y_sh = prm.f.y_ss = 0;
  prm.f.st_sb = prm.f.st_sh = prm.f.st_sl = 0;
  prm.dy = dy; prm.dst = static_cast<const float*>(dstates); prm.dx = dx;
  prm.ddt = static_cast<float*>(ddt); prm.da = static_cast<float*>(da);
  prm.part = static_cast<float*>(part);
  prm.rows = static_cast<double*>(rows);
  prm.dcum_extra = static_cast<const float*>(dcum);
  prm.dc_extra = static_cast<const float*>(dc_extra);
  prm.batch = batch; prm.groups = groups; prm.seqlen = seqlen;
  prm.splits = splits; prm.ndim = n;
  prm.dy_sb = dy_sb; prm.dy_sh = dy_sh; prm.dy_ss = dy_ss;
  prm.dst_sb = dst_sb; prm.dst_sh = dst_sh; prm.dst_sl = dst_sl;
  prm.dx_sb = dx_sb; prm.dx_sh = dx_sh; prm.dx_ss = dx_ss;
  prm.ddt_sb = ddt_sb; prm.ddt_sh = ddt_sh; prm.ddt_ss = ddt_ss;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch_bwd(prm, p, n, dtype,
                           static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
