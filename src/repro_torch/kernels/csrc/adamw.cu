// AdamW's whole step over many float32 tensors for Hopper (sm_90a), CUDA C++
// with plain C entry points that Python loads with ctypes.
//
// Replaces no Pallas kernel: the reference updates its leaves with jnp ops
// (src/repro/train/optimizer.py:adamw_update), and the port's plain version
// is the per-tensor loop of src/repro_torch/train/optimizer.py, some 15
// PyTorch launches a tensor and one norm a tensor (~7,300 launches for
// mamba2-780m's 434 tensors).  Two launches do the same for every tensor:
//
//   norm    every gradient's sum of squares, one block a chunk, each
//           block's float64 partial into `partials`; the last block to
//           finish (a counter in device memory, reset by that block) sums
//           the partials in a fixed order and writes out[0] = gnorm and
//           out[1] = scale = min(1, clip / (gnorm + 1e-9)), as the loop
//           computes them: no host sync.
//   update  one block a chunk: for each element, the loop's float32
//           operations in its order and roundings (below), reading scale
//           from device memory.
//
// A chunk is (tensor, start, length) with length <= the wrapper's CHUNK: a
// block never spans two tensors.  The chunk table and the tensor rows
// (pointers of p, mu, nu, numel, the decay flag) are device tables that
// the wrapper builds once per set of tensors; the gradients, new tensors
// every step, reach the kernels as a kernel parameter (`Grads`, up to
// kMaxTensors pointers; sm_90 takes up to 32 KB of parameters), so a call
// copies nothing to the device before it launches.
//
// The update, per element, as train/optimizer.py's loop runs it on the card
// (PyTorch multiplies a float32 tensor by a Python scalar rounded to
// float32, and divides by one as a multiply by the float32 reciprocal; the
// wrapper passes those constants):
//   g  = g * scale
//   mu = mu * b1 + c1 * g                        c1 = float32(1 - b1)
//   nu = nu * b2 + (c2 * g) * g                  c2 = float32(1 - b2)
//   d  = (mu * inv_b1c) / (sqrt(nu * inv_b2c) + eps)
//   d  = d + wd * p                              tensors of 2+ dimensions
//   p  = p - lr * d
// every operation rounded to nearest on its own (__f*_rn: nvcc contracts
// nothing into an FMA), so the result is bit-equal to the loop's.
//
// What bounds it on an H100: per parameter the update reads g and reads
// and writes p, mu and nu (28 bytes) for ~15 float operations, and the
// norm reads g once more (4 bytes): 32 bytes against 3.35 TB/s, far below
// the card's operations per byte.  The design answers that: 16-byte loads
// and stores (float4) wherever a chunk's four pointers are 16-byte aligned,
// a scalar loop for the rest of a chunk, one block of 256 threads a chunk
// so that the grid covers the card many times over.  The norm sums in
// float64 (a float32 sum over a thread's ~100 elements, then over the
// blocks, would drift by ~1e-6 of the norm; each float64 square of a float32
// is exact).
//
// The gradients are read only; their values are left as they were (the
// wrapper's callers treat them as consumed).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 1024;   // kernels/adamw.py: MAX_TENSORS

struct Grads {
  const float* g[kMaxTensors];
};

struct Chunk {        // int64 [n, 3] in the wrapper
  int64_t tensor;     // index into Grads and rows
  int64_t start;      // first element of the tensor
  int64_t len;        // elements
};

struct Row {          // int64 [n, 5] in the wrapper
  float* p;
  float* mu;
  float* nu;
  int64_t numel;
  int64_t decay;      // 1: the tensor has 2 or more dimensions
};

struct Consts {
  float b1, c1, b2, c2, inv_b1c, inv_b2c, eps, wd, lr;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__device__ __forceinline__ double square_sum4(float4 x) {
  const double a = x.x, b = x.y, c = x.z, d = x.w;
  return a * a + b * b + c * c + d * d;
}

// Sum of `v` over the block, in a fixed order; every thread gets it.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
  __shared__ double total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ Grads grads,
                  const Chunk* __restrict__ chunks, double* partials,
                  unsigned* done, float* __restrict__ out, float clip) {
  const Chunk c = chunks[blockIdx.x];
  const float* g = grads.g[c.tensor] + c.start;
  double acc = 0.0;
  int64_t head = 0;
  if (aligned16(g)) {
    head = c.len & ~int64_t(3);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = threadIdx.x; i < head / 4; i += kThreads)
      acc += square_sum4(__ldcs(g4 + i));
  }
  for (int64_t i = head + threadIdx.x; i < c.len; i += kThreads) {
    const double x = g[i];
    acc += x * x;
  }
  acc = block_sum(acc);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double sum = 0.0;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads)
    sum += __ldcg(partials + i);   // from L2: other blocks wrote them
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    const float gnorm = (float)sqrt(sum);
    // clamp(clip / (gnorm + 1e-9), max=1) as PyTorch runs it: the
    // reciprocal of gnorm + 1e-9f times clip; a NaN stays NaN
    const float s =
        __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(gnorm, 1e-9f)), clip);
    out[0] = gnorm;
    out[1] = s > 1.0f ? 1.0f : s;
    *done = 0u;       // ready for the next call
  }
}

__device__ __forceinline__ void adamw_element(float& p, float g, float& mu,
                                              float& nu, float scale,
                                              bool decay, const Consts& k) {
  g = __fmul_rn(g, scale);
  mu = __fadd_rn(__fmul_rn(mu, k.b1), __fmul_rn(k.c1, g));
  nu = __fadd_rn(__fmul_rn(nu, k.b2), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, k.inv_b2c)), k.eps);
  float d = __fdiv_rn(__fmul_rn(mu, k.inv_b1c), den);
  if (decay) d = __fadd_rn(d, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, d));
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Grads grads,
                    const Chunk* __restrict__ chunks,
                    const Row* __restrict__ rows,
                    const float* __restrict__ scale_ptr, Consts k) {
  const Chunk c = chunks[blockIdx.x];
  const Row r = rows[c.tensor];
  const float scale = *scale_ptr;
  const bool decay = r.decay != 0;
  float* p = r.p + c.start;
  float* mu = r.mu + c.start;
  float* nu = r.nu + c.start;
  const float* g = grads.g[c.tensor] + c.start;
  int64_t head = 0;
  if (aligned16(p) && aligned16(mu) && aligned16(nu) && aligned16(g)) {
    head = c.len & ~int64_t(3);
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(mu);
    float4* n4 = reinterpret_cast<float4*>(nu);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t i = threadIdx.x; i < head / 4; i += kThreads) {
      const float4 gv = __ldcs(g4 + i);
      float4 pv = p4[i], mv = m4[i], nv = n4[i];
      adamw_element(pv.x, gv.x, mv.x, nv.x, scale, decay, k);
      adamw_element(pv.y, gv.y, mv.y, nv.y, scale, decay, k);
      adamw_element(pv.z, gv.z, mv.z, nv.z, scale, decay, k);
      adamw_element(pv.w, gv.w, mv.w, nv.w, scale, decay, k);
      p4[i] = pv;
      m4[i] = mv;
      n4[i] = nv;
    }
  }
  for (int64_t i = head + threadIdx.x; i < c.len; i += kThreads) {
    float pv = p[i], mv = mu[i], nv = nu[i];
    adamw_element(pv, g[i], mv, nv, scale, decay, k);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = nv;
  }
}

cudaError_t fill_grads(Grads& grads, const void* const* g, int n) {
  if (n <= 0 || n > kMaxTensors) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) grads.g[i] = static_cast<const float*>(g[i]);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The gradients' global norm over `n_chunks` chunks (chunks: device int64
// [n_chunks, 3] of (tensor, start, len); grads: a host array of n device
// pointers, float32, indexed by the chunks' tensor): float64 partials, one
// a chunk, into partials (device, n_chunks doubles); the last block to
// finish, counted at `done` (a device int, 0 between calls), writes out[0]
// = the norm and out[1] = the clip scale and sets *done back to 0.
// Returns the CUDA error of the launch (0 on success).
int repro_adamw_norm(const void* chunks, int64_t n_chunks,
                     const void* const* grads, int n, void* partials,
                     void* done, void* out, float clip, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  Grads g;
  cudaError_t err = fill_grads(g, grads, n);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks <= 0 || n_chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  adamw_norm_kernel<<<(unsigned)n_chunks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const Chunk*>(chunks), static_cast<double*>(partials),
      static_cast<unsigned*>(done), static_cast<float*>(out), clip);
  return (int)cudaGetLastError();
}

// The update of every chunk (rows: device int64 [n, 5] of (p, mu, nu,
// numel, decay) indexed like grads), in place on p, mu and nu, with the
// scale read from device memory at `scale` and the float32 constants of the
// loop.  Returns the CUDA error of the launch (0 on success).
int repro_adamw_update(const void* chunks, int64_t n_chunks,
                       const void* const* grads, int n, const void* rows,
                       const void* scale, float b1, float c1, float b2,
                       float c2, float inv_b1c, float inv_b2c, float eps,
                       float wd, float lr, void* stream) {
  cudaGetLastError();
  Grads g;
  cudaError_t err = fill_grads(g, grads, n);
  if (err != cudaSuccess) return (int)err;
  if (n_chunks <= 0 || n_chunks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Consts k{b1, c1, b2, c2, inv_b1c, inv_b2c, eps, wd, lr};
  adamw_update_kernel<<<(unsigned)n_chunks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const Chunk*>(chunks), static_cast<const Row*>(rows),
      static_cast<const float*>(scale), k);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
