// Chunk accumulate for Hopper (sm_90a), CUDA C++ with a plain C entry point
// that Python loads with ctypes.
//
// Replaces the Pallas TPU kernel `_accum_kernel` / `chunk_accum` in
// src/repro/kernels/chunk_accum.py:23, the accumulate step of every
// reduce-scatter round.  Two forms, both in place on a float32 accumulator:
//
//   dense    acc[r, :]      += float(upd[r, :])   for r < rows  (the Pallas
//            kernel's function, acc + update.astype(f32), written back)
//   indexed  acc[idx[j], :] += float(upd[j, :])   for j < rows, skipping every
//            j with idx[j] == skip
//
// The indexed form fuses the executor's scatter-add (the reference does
// `buf.at[recv_idx].add(got)` at src/repro/comms/collectives.py:43 in XLA).
// `skip` is the program's trash row: a non-receiver's receive slots all name
// it, so one call may hold it many times, and skipping it keeps blocks from
// racing on that row.  Every other row appears at most once per call (the
// lowering gives each real slot one receiver per call), so each element gets
// exactly one float32 add and the result is bit-equal to the plain version.
// update is float32, bfloat16 or float16; acc and update are row-major with
// `cols` elements per row.
//
// What bounds it on an H100: one add per element against 4 + 4 bytes of acc
// (read, write) and 4 (f32) or 2 (bf16/f16) bytes of update, so 12 or 10
// bytes per add, far below the card's ~295 operations per byte: the bound is
// HBM, bytes / 3.35 TB/s.  The design answers that and nothing else: every
// thread moves 16 bytes of update per load (4 f32 or 8 bf16/f16 elements)
// and the matching 16 or 32 bytes of acc as float4s, in a grid-stride loop
// over the row, so neighbouring threads touch neighbouring addresses.  The
// grid is (column blocks, rows): a block walks rows with a stride of
// gridDim.y, reads each row's destination index once into shared memory,
// and the column blocks of one row cover it together.  Rows whose width is
// not a multiple of the vector, or unaligned pointers, take a scalar loop.
// The TPU kernel's [block_n, block_c] VMEM tiles have no counterpart: nothing
// is reused, so nothing is staged.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
chunk_accum_kernel(float* __restrict__ acc, const T* __restrict__ upd,
                   const int64_t* __restrict__ idx, int64_t rows,
                   int64_t cols, int64_t skip) {
  // elements per 16-byte load of the update
  constexpr int kV = kVec ? 16 / (int)sizeof(T) : 1;
  __shared__ int64_t dst_row;
  const int64_t steps = cols / kV;  // kVec => cols % kV == 0
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    if (threadIdx.x == 0) dst_row = idx != nullptr ? idx[r] : r;
    __syncthreads();
    const int64_t d = dst_row;
    __syncthreads();  // everyone has read dst_row before it changes
    if (d == skip) continue;
    float* a = acc + d * cols;
    const T* u = upd + r * cols;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < steps;
         i += stride) {
      if constexpr (kVec) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(u) + i);
        const T* vals = reinterpret_cast<const T*>(&raw);
        float4* ap = reinterpret_cast<float4*>(a) + i * (kV / 4);
#pragma unroll
        for (int q = 0; q < kV / 4; ++q) {
          float4 x = ap[q];
          x.x += to_f32(vals[4 * q + 0]);
          x.y += to_f32(vals[4 * q + 1]);
          x.z += to_f32(vals[4 * q + 2]);
          x.w += to_f32(vals[4 * q + 3]);
          ap[q] = x;
        }
      } else {
        a[i] += to_f32(u[i]);
      }
    }
  }
}

int num_sms() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T>
cudaError_t launch(float* acc, const void* upd, const int64_t* idx,
                   int64_t rows, int64_t cols, int64_t skip,
                   cudaStream_t stream) {
  constexpr int kV = 16 / (int)sizeof(T);
  const bool vec = cols % kV == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  const int64_t steps = vec ? cols / kV : cols;
  // enough blocks for ~8 resident per SM, spread over the rows first
  const int64_t target = 8LL * num_sms();
  const int64_t gy = rows < 65535 ? rows : 65535;
  int64_t gx = (steps + kThreads - 1) / kThreads;
  const int64_t want_x = (target + gy - 1) / gy;
  if (gx > want_x) gx = want_x;
  if (gx < 1) gx = 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const T* u = static_cast<const T*>(upd);
  if (vec)
    chunk_accum_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        acc, u, idx, rows, cols, skip);
  else
    chunk_accum_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        acc, u, idx, rows, cols, skip);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc: float32 [*, cols]; upd: [rows, cols] of dtype 0 = float32,
// 1 = bfloat16, 2 = float16; idx: int64 [rows] of acc rows, or null for the
// dense form (row j of upd into row j of acc).  Rows with idx[j] == skip are
// left alone (pass -1 when no row is to be skipped).  rows and cols > 0.
// Returns the CUDA error of the launch (0 on success).
int repro_chunk_accum(void* acc, const void* upd, int dtype,
                      const int64_t* idx, int64_t rows, int64_t cols,
                      int64_t skip, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  float* a = static_cast<float*>(acc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(a, upd, idx, rows, cols, skip, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(a, upd, idx, rows, cols, skip, s);
  else if (dtype == 2) err = launch<__half>(a, upd, idx, rows, cols, skip, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
