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
// y is written in x's type, state in float32.  All arithmetic is float32,
// except that cum is summed in float64 and each difference is rounded to
// float32 once, as the plain version (ssd_chunk_intra_reference) does: a
// float32 cumsum over 512 rows leaves errors near 1e-4 in L that depend on
// the order of the sum.  The mask is a select, never a product: above the
// diagonal cum[i] - cum[j] > 0 and exp may overflow to inf, and inf * 0 is
// NaN.
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
// zamba2-1.2b's Q = 256, N = 64 it is the bytes.  This first version does its
// products with float32 FMAs on the CUDA cores from shared memory, which
// makes it bound by shared-memory loads, far above either bound.  wgmma and
// TMA are for a later version.  What the design does: the Pallas kernel
// keeps the whole [Q, Q] decay matrix in VMEM (1 MiB at Q = 512); here L is
// formed 64 x 64 tiles at a time from cum in registers and never stored,
// key tiles wholly above the diagonal are skipped (half the work), and the
// chunk's state is one more block of the same launch.
//
// Grid: (ceil(Q / 64) + 1, S / Q, B * H).  Block x < ceil(Q / 64) computes
// y for 64 query rows of the chunk: it stages C[i] once and loops over key
// tiles of 64 rows, staging B[j] and x[j] dt[j], forming the 64 x 64 tile
// of scores (C . B) * L in shared memory, and adding its product with
// x dt into a [64, P] float32 accumulator in registers.  The last block x
// computes the chunk's [P, N] state, looping over the chunk's rows in tiles
// of 64 with B pre-scaled by its decay.  256 threads as a 16 x 16 grid:
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of each tile;
// shared rows are padded by one float, so the strided reads are free of
// bank conflicts.  Every block sums the chunk's cum itself (a two-level
// scan: 256 threads each sum a run of rows sequentially, then scan the run
// totals), in the same order in every block of the chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows per block, key rows per step
constexpr int kMaxChunk = 4096;    // cum and dt of one chunk in shared memory

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* st;
  int heads, chunk, row_tiles;
  int64_t x_sb, x_sh, x_ss;
  int64_t dt_sb, dt_sh, dt_ss;
  int64_t a_sb, a_sh;
  int64_t b_sb, b_sh, b_ss;
  int64_t c_sb, c_sh, c_ss;
  int64_t y_sb, y_sh, y_ss;
  int64_t st_sb, st_sh, st_sl;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int P, int N>
constexpr size_t smem_bytes(int chunk) {
  // cum (double) + run totals (double) + dt, then the tiles
  return sizeof(double) * (size_t)(chunk + kThreads) +
         sizeof(float) * (size_t)chunk +
         sizeof(float) * (size_t)(2 * kTile * (N + 1) + kTile * (P + 1) +
                                  kTile * (kTile + 1));
}

// cum[j] = sum_{t <= j} (float)(dt[j] * a), summed in double.
__device__ void chunk_cumsum(double* cum, double* runs, const float* sdt,
                             float a, int q) {
  const int t = threadIdx.x;
  const int per = (q + kThreads - 1) / kThreads;
  const int lo = min(t * per, q), hi = min(lo + per, q);
  double s = 0.0;
  for (int j = lo; j < hi; ++j) {
    const float da = sdt[j] * a;    // the float32 product, then the sum
    s += (double)da;
    cum[j] = s;
  }
  runs[t] = s;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {   // inclusive scan of runs
    const double v = t >= off ? runs[t - off] : 0.0;
    __syncthreads();
    runs[t] += v;
    __syncthreads();
  }
  const double base = t > 0 ? runs[t - 1] : 0.0;
  for (int j = lo; j < hi; ++j) cum[j] += base;
  __syncthreads();
}

// rows [row0, row0 + kTile) of a [Q, W] slice into dst [kTile][W + 1] as
// float, times scale[row] when scale is given; zero from row `rows` on.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0, int rows,
                                          const float* scale) {
  for (int idx = threadIdx.x; idx < kTile * W; idx += kThreads) {
    const int r = idx / W, k = idx % W;
    float v = 0.f;
    if (r < rows) {
      v = to_float(src[(int64_t)(row0 + r) * stride + k]);
      if (scale != nullptr) v *= scale[row0 + r];
    }
    dst[r * (W + 1) + k] = v;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const Params p) {
  constexpr int LN = N + 1, LP = P + 1, LS = kTile + 1;
  extern __shared__ double smem_d[];
  double* cum = smem_d;                        // [chunk]
  double* runs = cum + p.chunk;                // [kThreads]
  float* sdt = reinterpret_cast<float*>(runs + kThreads);   // [chunk]
  float* s_a = sdt + p.chunk;                  // [kTile][LN]: C, or B*decay
  float* s_b = s_a + kTile * LN;               // [kTile][LN]: B
  float* s_x = s_b + kTile * LN;               // [kTile][LP]: x * dt
  float* s_s = s_x + kTile * LP;               // [kTile][LS]: scores * L

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q = p.chunk;
  const int bi = blockIdx.z / p.heads, hi = blockIdx.z % p.heads;
  const int64_t row0 = (int64_t)blockIdx.y * q;   // the chunk's first row
  const T* xp = static_cast<const T*>(p.x) + bi * p.x_sb + hi * p.x_sh +
                row0 * p.x_ss;
  const float* dtp = p.dt + bi * p.dt_sb + hi * p.dt_sh + row0 * p.dt_ss;
  const T* bp = static_cast<const T*>(p.b) + bi * p.b_sb + hi * p.b_sh +
                row0 * p.b_ss;
  const T* cp = static_cast<const T*>(p.c) + bi * p.c_sb + hi * p.c_sh +
                row0 * p.c_ss;
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
      load_tile<T, P>(s_x, xp, p.x_ss, j0, rows, sdt);
      __syncthreads();              // sdt of this tile is read
      for (int r = threadIdx.x; r < rows; r += kThreads)
        sdt[j0 + r] = expf((float)(last - cum[j0 + r]));
      __syncthreads();
      load_tile<T, N>(s_a, bp, p.b_ss, j0, rows, sdt);
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
  load_tile<T, N>(s_a, cp, p.c_ss, i0, rows, nullptr);
  float acc[RQ][CP];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < i0 + rows; j0 += kTile) {   // key tiles up to the
    const int keys = min(kTile, q - j0);             // diagonal
    __syncthreads();                // the previous tile is consumed
    load_tile<T, N>(s_b, bp, p.b_ss, j0, keys, nullptr);
    load_tile<T, P>(s_x, xp, p.x_ss, j0, keys, sdt);
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
  T* yp = static_cast<T*>(p.y) + bi * p.y_sb + hi * p.y_sh +
          row0 * p.y_ss;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = i0 + ty + 16 * i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < CP; ++j) store(yp + r * p.y_ss + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, int bh, int chunks, cudaStream_t stream) {
  const size_t smem = smem_bytes<P, N>(p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.row_tiles + 1, chunks, bh);
  ssd_chunk_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t dispatch_n(const Params& p, int bh, int chunks, int n,
                       cudaStream_t s) {
  switch (n) {
    case 16: return launch<T, P, 16>(p, bh, chunks, s);
    case 32: return launch<T, P, 32>(p, bh, chunks, s);
    case 64: return launch<T, P, 64>(p, bh, chunks, s);
    case 128: return launch<T, P, 128>(p, bh, chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int bh, int chunks, int pd, int n,
                     cudaStream_t s) {
  switch (pd) {
    case 16: return dispatch_n<T, 16>(p, bh, chunks, n, s);
    case 32: return dispatch_n<T, 32>(p, bh, chunks, n, s);
    case 64: return dispatch_n<T, 64>(p, bh, chunks, n, s);
    case 128: return dispatch_n<T, 128>(p, bh, chunks, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, b, c and y: 0 = float32, 1 = bfloat16; dt, a and states are
// float32.  seqlen is a multiple of chunk, 1 <= chunk <= 4096; p and n are
// 16, 32, 64 or 128.  Strides are in elements; the last dimension of x, b,
// c and y is contiguous and states are [P, N] contiguous per (b, h, chunk).
// Returns the CUDA error of the launch (0 on success).
int repro_ssd_chunk_fwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* states, int dtype, int batch, int heads,
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
  Params prm;
  prm.x = x; prm.dt = static_cast<const float*>(dt);
  prm.a = static_cast<const float*>(a); prm.b = b; prm.c = c; prm.y = y;
  prm.st = static_cast<float*>(states);
  prm.heads = heads; prm.chunk = chunk;
  prm.row_tiles = (chunk + kTile - 1) / kTile;
  prm.x_sb = x_sb; prm.x_sh = x_sh; prm.x_ss = x_ss;
  prm.dt_sb = dt_sb; prm.dt_sh = dt_sh; prm.dt_ss = dt_ss;
  prm.a_sb = a_sb; prm.a_sh = a_sh;
  prm.b_sb = b_sb; prm.b_sh = b_sh; prm.b_ss = b_ss;
  prm.c_sb = c_sb; prm.c_sh = c_sh; prm.c_ss = c_ss;
  prm.y_sb = y_sb; prm.y_sh = y_sh; prm.y_ss = y_ss;
  prm.st_sb = st_sb; prm.st_sh = st_sh; prm.st_sl = st_sl;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, chunks = seqlen / chunk;
  cudaError_t err;
  if (dtype == 0) err = dispatch<float>(prm, bh, chunks, p, n, s);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(prm, bh, chunks, p, n, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
