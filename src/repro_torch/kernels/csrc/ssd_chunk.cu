// Mamba2 SSD intra-chunk block for Hopper (sm_90a), CUDA C++ with a plain C
// entry point that Python loads with ctypes.
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel` / `ssd_chunk_intra` in
// src/repro/kernels/ssd_scan.py:32.  For every (batch, head, chunk of Q rows)
// it computes, with cum = cumsum(dt * a) over the chunk:
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
