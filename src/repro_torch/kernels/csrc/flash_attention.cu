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
//
// What bounds it on an H100: at the serving shapes (S ~ 1k, D = 128) the work
// is ~4*S*D operations per loaded byte, far above the card's ~295 ops/byte, so
// the bound is the tensor cores' 989 TFLOP/s.  This first version does its
// products with fp32 FMAs on the CUDA cores (67 TFLOP/s peak) and feeds them
// from shared memory, so it is bound by shared-memory loads, well above the
// tensor-core bound.  What the design does about the rest: the TPU grid's
// sequential kv axis becomes a loop inside the block, so m, l and the output
// accumulator stay in registers for the whole row tile and no partial result
// goes to device memory; kv tiles wholly above the causal diagonal, or wholly
// below a sliding window, are skipped where every row keeps an unmasked
// column, which halves the causal work.  wgmma/TMA are for a later version.
//
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

namespace {

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ constexpr int kv_tile(int d) { return d >= 256 ? 32 : 64; }

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kBlockQ * (d + 1) + 2 * kv_tile(d) * (d + 1) +
                                  kBlockQ * (kv_tile(d) + 1));
}

// Rows [row0, row0 + rows) of a [S, D] slice into shared memory, zero past s.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0, int rows,
                                          int s) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < s ? to_float(src[row * stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
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
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<T, D>(sq, qp, p.q_ss, q0, kBlockQ, p.sq);

  // kv tiles this q tile visits
  const int q_last = min(q0 + kBlockQ, p.sq) - 1;
  int t_begin = 0, t_end = (p.skv + BK - 1) / BK;
  if (p.causal) {
    // above the diagonal: no row may attend past max(q_last, prefix_len - 1).
    // Skipping happens only when q_last < skv, where every row i keeps j = i.
    const int j_hi = max(q_last, p.prefix_len - 1);
    t_end = min(t_end, j_hi / BK + 1);
    // below the window: tiles whose columns all lie at or before
    // q0 - window, for rows that each keep their own column
    if (p.window > 0 && p.prefix_len == 0 && q_last < p.skv) {
      t_begin = max(0, (q0 - p.window + 1) / BK);
    }
  }

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
    load_tile<T, D>(sk, kp, p.k_ss, j0, BK, p.skv);
    load_tile<T, D>(sv, vp, p.v_ss, j0, BK, p.skv);
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
        const int c = j0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.logit_cap > 0.f) x = p.logit_cap * tanhf(x / p.logit_cap);
        if (c >= p.skv) {
          x = -INFINITY;  // padding: never enters the softmax
        } else if (p.causal) {
          bool ok = c <= r;
          if (p.window > 0) ok = ok && c > r - p.window;
          if (p.prefix_len > 0) ok = ok || c < p.prefix_len;
          if (!ok) x = kNegInf;
        }
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
    for (int c = 0; c < CD; ++c)
      store(op + r * p.o_ss + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.h, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
    case 128: return launch<T, 128>(p, b, stream);
    case 256: return launch<T, 256>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// Strides are in elements; the last dimension of every tensor is contiguous.
// Returns the CUDA error of the launch (0 on success).
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int b, int h, int hkv, int sq, int skv, int d,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, int window, int prefix_len, float logit_cap, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
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
  cudaError_t err;
  if (dtype == 0) err = dispatch_d<float>(p, b, d, s);
  else if (dtype == 1) err = dispatch_d<__nv_bfloat16>(p, b, d, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
