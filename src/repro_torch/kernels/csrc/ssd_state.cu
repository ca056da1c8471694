// Steps 3 and 4 of Mamba2's chunked SSD for Hopper (sm_90a), forward and
// backward, CUDA C++ with plain C entry points that Python loads with
// ctypes.
//
// Replaces no TPU kernel: the reference runs these steps as plain jnp ops
// after the Pallas kernel `_ssd_chunk_kernel` (src/repro/models/ssm.py,
// `ssd_chunked`).  They were added because, as plain ops under autograd,
// the two steps cost ~180 small device operations a layer on the card and
// set the pace of training from the host.  Per (batch, head), with the
// intra-chunk block's output y_diag and chunk states (csrc/ssd_chunk.cu)
// and cs = cumsum(dt a) over each chunk of Q rows:
//
//   carry[0] = init,  carry[l+1] = carry[l] exp(cs[l, Q-1]) + states[l]
//   entering[l] = carry[l] in the compute dtype               [P, N]
//   y[l] = y_diag[l] + (C[l] entering[l]^T) o sd[l],  sd = exp(cs) in the
//          compute dtype                                        [Q, P]
//
// and the backward given dy and the final state's gradient (the derivation
// is `ssd_state_bwd_reference` in kernels/ref.py):
//
//   dE[l]   = (sd o dy[l])^T C[l]          dcarry[l] = dcarry[l+1] D + dE[l]
//   dstates[l] = dcarry[l+1]               dcs[l, Q-1] += D sum(dcarry[l+1]
//   dc     += sum_h sd o (dy entering)                    o carry[l])
//   dcs     = exp(cs) o rowsum(C o (dy entering))
//
// with D = exp(cs[l, Q-1]); dstates and dcs go on to the intra-chunk
// block's backward (`repro_ssd_chunk_bwd`), which adds dcs to its own
// gradient of cum before the one reverse cumsum that gives ddt and da.
//
// What bounds them on an H100: at mamba2-780m's train shape (B = 2, S =
// 4096, 48 heads, P = 64, N = 128, Q = 512) the forward reads the float32
// chunk states (25 MB) and y_diag (50 MB) and writes y (50 MB), the float32
// carries (25 MB) and the bf16 entering states (12.6 MB): ~165 MB, 0.049 ms
// at 3.35 TB/s; the read-out's product is 6.4 GFLOP, 0.007 ms on the tensor
// cores.  The backward reads dy (50 MB), the carries and the entering
// states and writes the float32 dstates (25 MB), dcs and each head split's
// dc: ~120 MB, 0.036 ms; its two products 13 GFLOP.  Both are bound by
// bytes.  Only the carry and its gradient need the chunks in order, and
// they are elementwise, so each direction walks the chunks in a pass that
// moves just their bytes, and puts the products in a pass where every
// (chunk, row tile) runs at once:
//
//   forward:  `ssd_state_pass` walks the chunks of (batch, head, P-tile)
//             with the carry in float32 registers, sums cs in the order of
//             torch.cumsum on the card (one thread a chunk, in order, from
//             dt staged in shared memory) and writes the carries, the
//             entering states and cs; `ssd_readout_*` then runs one block a
//             (batch, head, chunk): the entering state stays in shared
//             memory while the chunk's C tiles stream past it (C is shared
//             by the heads, so it comes from L2), and y += (C E^T) o sd is
//             written in place over y_diag, the next row tile's C and
//             y_diag (through shared memory) and cs loaded while this
//             one's product runs.
//   backward: `ssd_state_grads_*` runs two kinds of block in one launch:
//             per (batch, head, chunk), dE = (sd o dy)^T C over the chunk's
//             row tiles (dE into the dstates buffer); per (batch, group,
//             chunk, row tile, split of the group's heads), dy E for each
//             head, its dcs rows e o rowsum(C o dy E) and the split's sum of
//             sd o dy E for dc.  `ssd_state_walk` then walks the chunks of
//             (batch, head) from the last, elementwise: dstates in place of
//             dE, the decay term into dcs[l, Q-1], dcarry, and d(init); its
//             other blocks add the head splits' dc in order (no atomics).
//
// Where (batch, head, P-tile) gives too few blocks to fill the card, the
// forward walk takes finer P-tiles (16, 32 or 64 rows of P): the carry's
// rows are independent, so it splits exactly.  Every sum runs in a fixed
// order: the same inputs give bit-equal outputs.
//
// bf16: one warpgroup a block, the products as warpgroup MMAs
// (csrc/hopper.cuh) with float32 accumulators: the read-out C E^T (C and E
// exact bf16); dy E (exact); and dE = (sd o dy)^T C, whose A operand is
// dy^T, read from the dy tile in shared memory transposed by ldmatrix
// (exact), times sd (a bf16 times a bf16, exact in float32) and carried in
// two bf16 parts.  fp32: the same passes on the CUDA cores, as float32
// FMAs.
//
// Measured on an H100 80GB HBM3 at 700 W at the train shape (device time
// from a CUDA graph over inputs beyond L2): the forward 0.090-0.094 ms
// (the read-out 48 us, the walk 38 us, against the bytes bound of 0.050
// ms), the backward 0.141-0.145 ms (the products 112 us, the walk 30 us,
// against 0.037 ms).  The backward's two kinds of block take 68 and 62 us
// alone and 115 us together; its read-out blocks hold 239 registers a
// thread (two blocks an SM), and bounding them to three or four blocks an
// SM spills and runs slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;          // rows of a tile
constexpr int kThreads = 128;      // one warpgroup
constexpr int kStage = 8192;       // dt / cs floats of a group of chunks
constexpr int kPassThreads = 256;  // the forward walk's threads
constexpr int kMaxGroups = 4;      // 8-float groups of the carry a thread
                                   // of it holds: 64 x 128 / 8 / 256
constexpr int kWalkThreads = 512;  // the backward walk's threads
constexpr int kWalkVec = 8;        // float4 of dcarry a thread of it holds:
                                   // 128 x 128 / 4 / 512
constexpr int kF32Threads = 256;   // the fp32 kernels' 16 x 16 threads
constexpr int kF32Elems = 32;      // elements a thread of them holds

typedef __nv_bfloat16 T16;

struct FwdParams {
  void* y;              // [B,H,S,P] y_diag in, y out (compute dtype)
  const float* st;      // [B,H,L,P,N] chunk states
  const float* dt;      // [B,H,S]
  const float* a;       // [B,H]
  const void* c;        // [B,H,S,N] (compute dtype); head stride 0: shared
  const float* init;    // [B*H, P, N] or null
  float* fin;           // [B*H, P, N]
  float* carries;       // [B*H, L, P, N] float32 (bf16 only; else null)
  void* entering;       // [B*H, L, P, N] compute dtype
  float* cs;            // [B*H, S]
  int heads, seqlen, chunk, pdim, ndim, ptile;
  int64_t y_sb, y_sh, y_ss;
  int64_t st_sb, st_sh, st_sl;
  int64_t dt_sb, dt_sh, dt_ss;
  int64_t a_sb, a_sh;
  int64_t c_sb, c_sh, c_ss;
};

struct BwdParams {
  const void* dy;       // [B,H,S,P] compute dtype
  const float* dfinal;  // [B*H, P, N] or null
  const float* carries; // [B*H, L, P, N] float32
  const void* entering; // [B*H, L, P, N] compute dtype
  const float* cs;      // [B*H, S]
  const void* c;        // [B,G,S,N]
  float* dstates;       // [B*H, L, P, N]: dE, then dstates
  float* dinit;         // [B*H, P, N] or null
  float* dcum;          // [B*H, S]
  float* dc_part;       // [splits, B, G, S, N]
  float* dc;            // [B, G, S, N]: the splits' sum (splits > 1)
  int batch, heads, groups, seqlen, chunk, pdim, ndim, splits;
  int64_t dy_sb, dy_sh, dy_ss;
  int64_t c_sb, c_sg, c_ss;
};

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sums over the four threads of a quad (the threads of one fragment row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v, in a fixed order (warps, then their totals in
// order); every thread gets it.  `red` holds one float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  v = warp_sum(v);
  __syncthreads();                  // red is free
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += red[w];
  return s;
}

// v d + e, elementwise, the product rounded before the sum
__device__ __forceinline__ float4 mul_add4(float4 v, float d, float4 e) {
  return make_float4(__fadd_rn(__fmul_rn(v.x, d), e.x),
                     __fadd_rn(__fmul_rn(v.y, d), e.y),
                     __fadd_rn(__fmul_rn(v.z, d), e.z),
                     __fadd_rn(__fmul_rn(v.w, d), e.w));
}

// ---------------------------------------------------------------------------
// The forward walk: grid (B * H, P / ptile), kPassThreads threads.  Thread
// t holds 8-float groups t, t + kPassThreads, ... of the block's ptile x N
// elements of the carry; each chunk's states are loaded while the one
// before is stepped.

template <typename TE>
__global__ void __launch_bounds__(kPassThreads) ssd_state_pass(const FwdParams p) {
  extern __shared__ float s_cs[];             // [group * chunk]
  const int q = p.chunk, chunks = p.seqlen / q;
  const int bh = blockIdx.x, bi = bh / p.heads, hi = bh % p.heads;
  const int pt = blockIdx.y;
  const float a = p.a[bi * p.a_sb + hi * p.a_sh];
  const int groups8 = p.ptile * p.ndim / 8;
  const int64_t block = (int64_t)p.pdim * p.ndim;          // [P, N]
  const int64_t off = (int64_t)pt * p.ptile * p.ndim;      // its rows
  const float* stb = p.st + bi * p.st_sb + hi * p.st_sh + off;

  float carry[kMaxGroups][8], nxt[kMaxGroups][8];
  auto load_states = [&](int l) {
#pragma unroll
    for (int i = 0; i < kMaxGroups; ++i) {
      const int k = threadIdx.x + i * kPassThreads;
      if (k < groups8) {
        const float* src = stb + l * p.st_sl + 8 * k;
        const float4 s0 = *reinterpret_cast<const float4*>(src);
        const float4 s1 = *reinterpret_cast<const float4*>(src + 4);
        nxt[i][0] = s0.x; nxt[i][1] = s0.y; nxt[i][2] = s0.z;
        nxt[i][3] = s0.w; nxt[i][4] = s1.x; nxt[i][5] = s1.y;
        nxt[i][6] = s1.z; nxt[i][7] = s1.w;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int k = threadIdx.x + i * kPassThreads;
#pragma unroll
    for (int e = 0; e < 8; ++e) carry[i][e] = nxt[i][e] = 0.f;
    if (k < groups8 && p.init != nullptr) {
      const float* src = p.init + bh * block + off + 8 * k;
      const float4 v0 = *reinterpret_cast<const float4*>(src);
      const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
      carry[i][0] = v0.x; carry[i][1] = v0.y; carry[i][2] = v0.z;
      carry[i][3] = v0.w; carry[i][4] = v1.x; carry[i][5] = v1.y;
      carry[i][6] = v1.z; carry[i][7] = v1.w;
    }
  }
  load_states(0);

  const int group = max(1, min(chunks, kStage / q));
  const float* dtp = p.dt + bi * p.dt_sb + hi * p.dt_sh;
  for (int l0 = 0; l0 < chunks; l0 += group) {
    const int g = min(group, chunks - l0);
    const int64_t row0 = (int64_t)l0 * q;
    // cs of chunks l0 .. l0 + g - 1: dt staged, then one thread a chunk
    // sums dt * a in order, as torch.cumsum does on the card, 16 rows of
    // shared memory read ahead of the adds
    for (int i = threadIdx.x; i < g * q; i += kPassThreads)
      s_cs[i] = dtp[(row0 + i) * p.dt_ss];
    __syncthreads();
    for (int k = threadIdx.x; k < g; k += kPassThreads) {
      float* v = s_cs + k * q;
      float s = 0.f;
      int j = 0;
      for (; j + 16 <= q; j += 16) {
        float w[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) w[u] = v[j + u];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          s = __fadd_rn(s, __fmul_rn(w[u], a));
          v[j + u] = s;
        }
      }
      for (; j < q; ++j) {
        s = __fadd_rn(s, __fmul_rn(v[j], a));
        v[j] = s;
      }
    }
    __syncthreads();
    if (pt == 0)
      for (int i = threadIdx.x; i < g * q; i += kPassThreads)
        p.cs[(int64_t)bh * p.seqlen + row0 + i] = s_cs[i];

    for (int l = l0; l < l0 + g; ++l) {
      const float decay = expf(s_cs[(l - l0) * q + q - 1]);
      const int64_t at = ((int64_t)bh * chunks + l) * block + off;
      float sv[kMaxGroups][8];
#pragma unroll
      for (int i = 0; i < kMaxGroups; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[i][e] = nxt[i][e];
      if (l + 1 < chunks) load_states(l + 1);
#pragma unroll
      for (int i = 0; i < kMaxGroups; ++i) {
        const int k = threadIdx.x + i * kPassThreads;
        if (k < groups8) {
          float* cp = (sizeof(TE) == 4 ? static_cast<float*>(p.entering)
                                       : p.carries) + at + 8 * k;
          *reinterpret_cast<float4*>(cp) = make_float4(
              carry[i][0], carry[i][1], carry[i][2], carry[i][3]);
          *reinterpret_cast<float4*>(cp + 4) = make_float4(
              carry[i][4], carry[i][5], carry[i][6], carry[i][7]);
          if (sizeof(TE) == 2) {          // the entering state, rounded
            uint4 w;
            w.x = hopper::pack_bf16(carry[i][0], carry[i][1]);
            w.y = hopper::pack_bf16(carry[i][2], carry[i][3]);
            w.z = hopper::pack_bf16(carry[i][4], carry[i][5]);
            w.w = hopper::pack_bf16(carry[i][6], carry[i][7]);
            *reinterpret_cast<uint4*>(static_cast<T16*>(p.entering) + at +
                                      8 * k) = w;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e)
            carry[i][e] = __fadd_rn(__fmul_rn(carry[i][e], decay), sv[i][e]);
        }
      }
    }
    __syncthreads();                  // s_cs is read before the next group
  }
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int k = threadIdx.x + i * kPassThreads;
    if (k < groups8) {
      float* dst = p.fin + bh * block + off + 8 * k;
      *reinterpret_cast<float4*>(dst) = make_float4(
          carry[i][0], carry[i][1], carry[i][2], carry[i][3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(
          carry[i][4], carry[i][5], carry[i][6], carry[i][7]);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward walk: grid (B * H + sum blocks), kWalkThreads threads.  A
// block below B * H walks the chunks of one (batch, head) from the last,
// thread t holding float4s t, t + kWalkThreads, ... of dcarry [P, N]: per
// chunk it reads dE (from the dstates buffer) and the carry, writes
// dstates in dE's place, adds D sum(dcarry o carry) into dcs[l, Q-1] (after
// the read-out's rows are there) and steps dcarry; then d(init).  The
// blocks from B * H on add the head splits' dc in order, 4 floats a thread.
__global__ void __launch_bounds__(kWalkThreads) ssd_state_walk(const BwdParams p) {
  __shared__ float red[kWalkThreads / 32];
  const int bhs = p.batch * p.heads;
  if ((int)blockIdx.x >= bhs) {
    const int64_t total = (int64_t)p.batch * p.groups * p.seqlen * p.ndim;
    const int64_t at =
        ((int64_t)(blockIdx.x - bhs) * kWalkThreads + threadIdx.x) * 4;
    if (at >= total) return;
    float4 s = *reinterpret_cast<const float4*>(p.dc_part + at);
    for (int k = 1; k < p.splits; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(p.dc_part + k * total + at);
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    *reinterpret_cast<float4*>(p.dc + at) = s;
    return;
  }
  const int bh = blockIdx.x, q = p.chunk, chunks = p.seqlen / q;
  const int64_t block = (int64_t)p.pdim * p.ndim;
  const int v4 = (int)(block / 4);
  float4 dcarry[kWalkVec];
#pragma unroll
  for (int i = 0; i < kWalkVec; ++i) {
    const int k = threadIdx.x + i * kWalkThreads;
    dcarry[i] = p.dfinal != nullptr && k < v4
                    ? *reinterpret_cast<const float4*>(p.dfinal + bh * block +
                                                       4 * k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int l = chunks - 1; l >= 0; --l) {
    const int64_t last = (int64_t)bh * p.seqlen + (int64_t)l * q + q - 1;
    const float decay = expf(p.cs[last]);
    float* dst = p.dstates + ((int64_t)bh * chunks + l) * block;
    const float* car = p.carries + ((int64_t)bh * chunks + l) * block;
    float4 de[kWalkVec], cr[kWalkVec];
#pragma unroll
    for (int i = 0; i < kWalkVec; ++i) {
      const int k = threadIdx.x + i * kWalkThreads;
      if (k < v4) {
        de[i] = *reinterpret_cast<const float4*>(dst + 4 * k);
        cr[i] = *reinterpret_cast<const float4*>(car + 4 * k);
      }
    }
    float dd = 0.f;
#pragma unroll
    for (int i = 0; i < kWalkVec; ++i) {
      const int k = threadIdx.x + i * kWalkThreads;
      if (k < v4) {
        *reinterpret_cast<float4*>(dst + 4 * k) = dcarry[i];
        dd = fmaf(dcarry[i].x, cr[i].x, dd);
        dd = fmaf(dcarry[i].y, cr[i].y, dd);
        dd = fmaf(dcarry[i].z, cr[i].z, dd);
        dd = fmaf(dcarry[i].w, cr[i].w, dd);
        dcarry[i] = mul_add4(dcarry[i], decay, de[i]);
      }
    }
    dd = block_sum(dd, red);
    if (threadIdx.x == 0) p.dcum[last] += dd * decay;
  }
  if (p.dinit != nullptr)
#pragma unroll
    for (int i = 0; i < kWalkVec; ++i) {
      const int k = threadIdx.x + i * kWalkThreads;
      if (k < v4)
        *reinterpret_cast<float4*>(p.dinit + bh * block + 4 * k) = dcarry[i];
    }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

namespace bf16 {

// Rows [row0, row0 + ROWS) of a [S, D] slice (row stride `stride`) into
// the tile at `dst` in TileLoader<D>'s layout for a tile of ROWS rows, by
// 16-byte cp.async into the current group; rows at or past `limit`
// zero-filled (not read).
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T16* src,
                                          int64_t stride, int row0,
                                          int limit) {
  using Load = hopper::TileLoader<D, kThreads>;
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH;
    const bool in = row0 + r < limit;
    hopper::cp_async_16(dst + Load::template offset<ROWS>(r, ch),
                        in ? src + (int64_t)(row0 + r) * stride + 8 * ch
                           : src,
                        in ? 16 : 0);
  }
}

// D[64 x NB] (+)= A Bt^T over K = KD: A a 64-row tile and Bt an NB-row
// tile, both K-major (rows of KD).
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

// D[64 x NB] = A B over K = KD: A a 64-row tile, K-major (rows of KD); B a
// tile of KD rows of NB, MN-major.
template <int KD, int NB>
__device__ __forceinline__ void mma_nn(float (&d)[NB / 2], uint32_t a,
                                       uint32_t b) {
  constexpr int WA = hopper::TileShape<KD>::W, CA = hopper::TileShape<KD>::CB;
  constexpr int WB = hopper::TileShape<NB>::W;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t col = (kk * 16) % CA * 2, blk = (kk * 16) / CA;
    hopper::Wgmma<NB>::template ss<1>(
        d, hopper::smem_desc<WA>(a + blk * (kTile * WA) + col, 16, 8 * WA),
        hopper::smem_desc<WB>(b + kk * 16 * WB, KD * WB, 8 * WB), kk > 0);
  }
}

// D[64 x NB] += A[64 x K] B[K x NB]: A from registers (K / 16 steps of
// four bf16 pairs), B a tile of K rows, MN-major.
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

// v and its rounded remainder as two bf16 operands: hi + lo is v to ~2**-16
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = hopper::pack_bf16(v0, v1);
  lo = hopper::pack_bf16(v0 - hopper::bf16_lo(hi), v1 - hopper::bf16_hi(hi));
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed: lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes), and r[k]
// receives matrix k's transposed rows t / 4, columns 2 (t % 4) and + 1 for
// lane t, the layout of an A operand's registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// shared-memory bytes of a [ROWS, D] bf16 tile, in whole 1024-byte units
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return (rows * d * 2 + 1023) / 1024 * 1024;
}

// The read-out: grid (B * H, L), one block a (batch, head, chunk).  The
// entering state [P, N] stays in shared memory; the chunk's C tiles and
// y_diag's row tiles stream through two stages (y_diag in rows padded by
// 16 bytes, so the epilogue's reads of the accumulator layout are free of
// bank conflicts); y = y_diag + bf16((C E^T) sd) is formed in place in
// shared memory and written back in 16-byte rows, the next row tile's cs
// read into registers while this one's product runs.
template <int P, int N>
struct ReadoutSmem {
  static constexpr int E_BYTES = tile_bytes(P, N);
  static constexpr int C_BYTES = tile_bytes(kTile, N);
  static constexpr int Y_ROW = 2 * P + 16;              // bytes a y row
  static constexpr int Y_BYTES = (kTile * Y_ROW + 1023) / 1024 * 1024;
  static constexpr int BYTES = 1024 + E_BYTES + 2 * C_BYTES + 2 * Y_BYTES;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_readout_bf16(const FwdParams p) {
  using L = ReadoutSmem<P, N>;
  constexpr int NO = P / 2, CH = P / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  uint8_t* raw = smem_raw - base;          // shared address 0, generic
  const uint32_t s_e = (base + 1023) & ~1023u;
  const uint32_t s_c = s_e + L::E_BYTES;
  const uint32_t s_y = s_c + 2 * L::C_BYTES;
  auto c_stage = [&](int t) { return s_c + (uint32_t)(t & 1) * L::C_BYTES; };
  auto y_stage = [&](int t) { return s_y + (uint32_t)(t & 1) * L::Y_BYTES; };
  const int q = p.chunk, chunks = p.seqlen / q;
  const int tiles = (q + kTile - 1) / kTile;
  const int bh = blockIdx.x, l = blockIdx.y;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int64_t row0 = (int64_t)l * q;
  const T16* cp = static_cast<const T16*>(p.c) + bi * p.c_sb + hi * p.c_sh +
                  row0 * p.c_ss;
  const T16* ep = static_cast<const T16*>(p.entering) +
                  ((int64_t)bh * chunks + l) * P * N;
  T16* yp = static_cast<T16*>(p.y) + bi * p.y_sb + hi * p.y_sh +
            row0 * p.y_ss;
  const float* csp = p.cs + (int64_t)bh * p.seqlen + row0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4, r = 16 * warp + lane / 4;

  // stage t: C's row tile and y_diag's, rows past the chunk zero-filled
  auto load = [&](int t) {
    load_rows<N, kTile>(c_stage(t), cp, p.c_ss, t * kTile, q);
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int rr = i / CH, ch = i % CH, row = t * kTile + rr;
      hopper::cp_async_16(y_stage(t) + rr * L::Y_ROW + 16 * ch,
                          row < q ? yp + (int64_t)row * p.y_ss + 8 * ch : yp,
                          row < q ? 16 : 0);
    }
    hopper::cp_async_commit();
  };
  // cs of this thread's rows r and r + 8 of tile t
  float cd[2], cn[2];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = t * kTile + r + 8 * half;
      cn[half] = i < q ? csp[i] : 0.f;
    }
  };

  load_rows<N, P>(s_e, ep, N, 0, P);
  load(0);
  prefetch(0);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cd[0] = cn[0];
    cd[1] = cn[1];
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();                // stage t landed; stage t - 1 is free
    if (t + 1 < tiles) {
      load(t + 1);
      prefetch(t + 1);
    }
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
    mma_nt<N, P>(acc, c_stage(t), s_e, false);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    // acc[4k + e] is row r + 8 (e / 2), column 8 k + 2 quad + e % 2; y of
    // those elements over y_diag's in shared memory
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float sd = round_bf16(expf(cd[half]));
      uint8_t* row = raw + y_stage(t) + (r + 8 * half) * L::Y_ROW;
#pragma unroll
      for (int k = 0; k < NO; k += 4) {
        uint32_t* at = reinterpret_cast<uint32_t*>(row + 2 * (8 * (k / 4) +
                                                              2 * quad));
        const uint32_t y0 = *at;
        const float v0 = round_bf16(acc[k + 2 * half] * sd);
        const float v1 = round_bf16(acc[k + 2 * half + 1] * sd);
        *at = hopper::pack_bf16(hopper::bf16_lo(y0) + v0,
                                hopper::bf16_hi(y0) + v1);
      }
    }
    __syncthreads();                // the tile's y is formed
    for (int i = tid; i < kTile * CH; i += kThreads) {
      const int rr = i / CH, ch = i % CH, row = t * kTile + rr;
      if (row < q)
        *reinterpret_cast<uint4*>(yp + (int64_t)row * p.y_ss + 8 * ch) =
            *reinterpret_cast<const uint4*>(raw + y_stage(t) +
                                            rr * L::Y_ROW + 16 * ch);
    }
  }
}

// dE blocks of `ssd_state_grads_bf16`: one a (batch, head, chunk, half of
// P when P = 128).  dE's accumulator fragments are [64 x N] with the
// block's rows of P as rows (rows from P on stay zero).  Per row tile of
// the chunk: the A operand dy^T, read from the dy tile transposed by
// ldmatrix (exact), times sd in two bf16 parts, dE += (sd o dy)^T C; dy
// and C tiles through two stages, the next tile's cs read into registers
// while this one's products run.
template <int P, int N>
__device__ __forceinline__ void de_block(const BwdParams& p, int idx,
                                         uint8_t* smem_raw) {
  constexpr int PROWS = P < kTile ? P : kTile;       // rows of P a block takes
  constexpr int DY_BYTES = tile_bytes(kTile, P), C_BYTES = tile_bytes(kTile, N);
  constexpr int NO = N / 2;
  using LoadP = hopper::TileLoader<P, kThreads>;
  const uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t s_dy = (base + 1023) & ~1023u;
  const uint32_t s_c = s_dy + 2 * DY_BYTES;
  auto dy_stage = [&](int t) { return s_dy + (uint32_t)(t & 1) * DY_BYTES; };
  auto c_stage = [&](int t) { return s_c + (uint32_t)(t & 1) * C_BYTES; };

  const int q = p.chunk, chunks = p.seqlen / q;
  const int tiles = (q + kTile - 1) / kTile;
  const int ph = idx % (P / PROWS), rest = idx / (P / PROWS);
  const int l = rest % chunks, bh = rest / chunks;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int g = hi / (p.heads / p.groups), p0 = ph * PROWS;
  const int64_t row0 = (int64_t)l * q;
  const T16* dyb = static_cast<const T16*>(p.dy) + bi * p.dy_sb +
                   hi * p.dy_sh + row0 * p.dy_ss;
  const T16* cb = static_cast<const T16*>(p.c) + bi * p.c_sb + g * p.c_sg +
                  row0 * p.c_ss;
  const float* csp = p.cs + (int64_t)bh * p.seqlen + row0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4, r = 16 * warp + lane / 4;
  // this warp's 16 rows of P hold data (rows from P on stay zero)
  const bool rows_in = 16 * warp < PROWS;
  // the dy tile's chunk of 8 columns and its row offset that this lane
  // addresses for ldmatrix: matrix lane / 8 is (rows of P + 8 (m % 2),
  // rows of the tile + 8 (m / 2))
  const int lm = lane / 8;
  const int ld_chunk = (p0 + 16 * warp + 8 * (lm % 2)) / 8;
  const int ld_row = 8 * (lm / 2) + lane % 8;

  auto load = [&](int t) {
    load_rows<P, kTile>(dy_stage(t), dyb, p.dy_ss, t * kTile, q);
    load_rows<N, kTile>(c_stage(t), cb, p.c_ss, t * kTile, q);
    hopper::cp_async_commit();
  };
  // cs of this thread's columns j = 64 t + 8 i + 2 quad + e of dy^T; -inf
  // (sd 0) past the chunk
  float cur[16], nxt[16];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = t * kTile + 8 * i + 2 * quad + e;
        nxt[2 * i + e] = j < q ? csp[j] : -INFINITY;
      }
  };
  load(0);
  prefetch(0);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();                // tile t landed; tile t - 1 is free
    if (t + 1 < tiles) {
      load(t + 1);
      prefetch(t + 1);
    }
    // (sd o dy)^T in two bf16 parts, the A operand of k-step kk in
    // registers 4 kk .. 4 kk + 3: register j holds rows r + 8 (j % 2),
    // columns 16 kk + 8 (j / 2) + 2 quad and + 1
    uint32_t xh[16], xl[16];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a4[4] = {0u, 0u, 0u, 0u};
      if (rows_in)
        ldmatrix_x4_trans(
            a4, dy_stage(t) + LoadP::template offset<kTile>(
                                  16 * kk + ld_row, ld_chunk));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 2 * kk + j / 2;          // column group 8 i
        const float sd0 = round_bf16(expf(cur[2 * i]));
        const float sd1 = round_bf16(expf(cur[2 * i + 1]));
        split(hopper::bf16_lo(a4[j]) * sd0, hopper::bf16_hi(a4[j]) * sd1,
              xh[4 * kk + j], xl[4 * kk + j]);
      }
    }
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
    mma_rn<N, kTile>(acc, xh, c_stage(t));
    mma_rn<N, kTile>(acc, xl, c_stage(t));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    hopper::fence_operands(xh);
    hopper::fence_operands(xl);
  }
  float* out = p.dstates + ((int64_t)bh * chunks + l) * P * N +
               (int64_t)p0 * N;
#pragma unroll
  for (int i = 0; i < NO; i += 4)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r + 8 * half;
      if (m < PROWS)
        *reinterpret_cast<float2*>(out + (int64_t)m * N + 8 * (i / 4) +
                                   2 * quad) =
            make_float2(acc[i + 2 * half], acc[i + 2 * half + 1]);
    }
}

// Read-out blocks of `ssd_state_grads_bf16`: one a (batch, group, chunk,
// row tile, split of the group's heads).  C's fragments stay in registers;
// per head, Gr = dy E on the tensor cores (dy and E tiles through two
// stages, the next head's cs read into registers meanwhile), dc += sd o
// Gr, and the head's dcs rows e o rowsum(C o Gr) are written.
template <int P, int N>
__device__ __forceinline__ void readout_grad_block(const BwdParams& p,
                                                   int idx,
                                                   uint8_t* smem_raw) {
  constexpr int DY_BYTES = tile_bytes(kTile, P), E_BYTES = tile_bytes(P, N);
  constexpr int NO = N / 2;
  const uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t s_dy = (base + 1023) & ~1023u;
  const uint32_t s_e = s_dy + 2 * DY_BYTES;
  auto dy_stage = [&](int k) { return s_dy + (uint32_t)(k & 1) * DY_BYTES; };
  auto e_stage = [&](int k) { return s_e + (uint32_t)(k & 1) * E_BYTES; };

  const int q = p.chunk, chunks = p.seqlen / q;
  const int tiles = (q + kTile - 1) / kTile;
  const int split = idx % p.splits, t = (idx / p.splits) % tiles;
  const int rest = idx / p.splits / tiles;
  const int l = rest % chunks, bg = rest / chunks;
  const int bi = bg / p.groups, g = bg % p.groups;
  const int hpg = p.heads / p.groups;
  const int h_lo = g * hpg + split * hpg / p.splits;
  const int h_hi = g * hpg + (split + 1) * hpg / p.splits;
  const int64_t row0 = (int64_t)l * q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4, r = 16 * warp + lane / 4;
  const int qa = t * kTile + r, qb = qa + 8;     // this thread's rows

  // C at this thread's fragment positions, as bf16 pairs
  const T16* cb = static_cast<const T16*>(p.c) + bi * p.c_sb + g * p.c_sg +
                  row0 * p.c_ss;
  uint32_t ca[N / 8], cc[N / 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int col = 8 * i + 2 * quad;
    ca[i] = qa < q ? *reinterpret_cast<const uint32_t*>(cb + qa * p.c_ss + col)
                   : 0u;
    cc[i] = qb < q ? *reinterpret_cast<const uint32_t*>(cb + qb * p.c_ss + col)
                   : 0u;
  }
  auto load = [&](int h, int k) {
    load_rows<P, kTile>(dy_stage(k),
                        static_cast<const T16*>(p.dy) + bi * p.dy_sb +
                            h * p.dy_sh + row0 * p.dy_ss,
                        p.dy_ss, t * kTile, q);
    load_rows<N, P>(e_stage(k),
                    static_cast<const T16*>(p.entering) +
                        ((int64_t)(bi * p.heads + h) * chunks + l) * P * N,
                    N, 0, P);
    hopper::cp_async_commit();
  };
  float csa = 0.f, csb = 0.f, nsa = 0.f, nsb = 0.f;
  auto prefetch = [&](int h) {
    const float* csp = p.cs + ((int64_t)bi * p.heads + h) * p.seqlen + row0;
    nsa = qa < q ? csp[qa] : 0.f;
    nsb = qb < q ? csp[qb] : 0.f;
  };

  float dc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dc[i] = 0.f;
  load(h_lo, 0);
  prefetch(h_lo);
  for (int h = h_lo; h < h_hi; ++h) {
    const int k = h - h_lo;
    csa = nsa;
    csb = nsb;
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();                // head k landed; stage k - 1 is free
    if (h + 1 < h_hi) {
      load(h + 1, k + 1);
      prefetch(h + 1);
    }
    float gr[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) gr[i] = 0.f;
    hopper::fence_operands(gr);
    hopper::wgmma_fence();
    mma_nn<P, N>(gr, dy_stage(k), e_stage(k));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(gr);

    const float ea = qa < q ? expf(csa) : 0.f;
    const float eb = qb < q ? expf(csb) : 0.f;
    const float sda = round_bf16(ea), sdb = round_bf16(eb);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      sa = fmaf(hopper::bf16_lo(ca[i]), gr[4 * i], sa);
      sa = fmaf(hopper::bf16_hi(ca[i]), gr[4 * i + 1], sa);
      sb = fmaf(hopper::bf16_lo(cc[i]), gr[4 * i + 2], sb);
      sb = fmaf(hopper::bf16_hi(cc[i]), gr[4 * i + 3], sb);
      dc[4 * i] = fmaf(sda, gr[4 * i], dc[4 * i]);
      dc[4 * i + 1] = fmaf(sda, gr[4 * i + 1], dc[4 * i + 1]);
      dc[4 * i + 2] = fmaf(sdb, gr[4 * i + 2], dc[4 * i + 2]);
      dc[4 * i + 3] = fmaf(sdb, gr[4 * i + 3], dc[4 * i + 3]);
    }
    sa = quad_sum(sa);
    sb = quad_sum(sb);
    if (quad == 0) {
      float* out = p.dcum + ((int64_t)bi * p.heads + h) * p.seqlen + row0;
      if (qa < q) out[qa] = sa * ea;
      if (qb < q) out[qb] = sb * eb;
    }
  }
  float* part = p.dc_part +
                ((((int64_t)split * p.batch + bi) * p.groups + g) * p.seqlen +
                 row0) * N;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int col = 8 * (i / 4) + 2 * quad;
    if (qa < q)
      *reinterpret_cast<float2*>(part + (int64_t)qa * N + col) =
          make_float2(dc[i], dc[i + 1]);
    if (qb < q)
      *reinterpret_cast<float2*>(part + (int64_t)qb * N + col) =
          make_float2(dc[i + 2], dc[i + 3]);
  }
}

template <int P, int N>
struct GradSmem {
  static constexpr int DE = 1024 + 2 * tile_bytes(kTile, P) +
                            2 * tile_bytes(kTile, N);
  static constexpr int RO = 1024 + 2 * tile_bytes(kTile, P) +
                            2 * tile_bytes(P, N);
  static constexpr int BYTES = DE > RO ? DE : RO;
};

// The backward's products: grid (read-out blocks + dE blocks), the
// read-out's first (each walks a split's heads, the longer walk).
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_grads_bf16(const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const int tiles = (p.chunk + kTile - 1) / kTile;
  const int readouts = p.batch * p.groups * (p.seqlen / p.chunk) * tiles *
                       p.splits;
  if ((int)blockIdx.x < readouts)
    readout_grad_block<P, N>(p, blockIdx.x, smem_raw);
  else
    de_block<P, N>(p, blockIdx.x - readouts, smem_raw);
}

template <int P, int N>
cudaError_t launch_fwd(const FwdParams& p, int bh, int chunks,
                       cudaStream_t s) {
  constexpr size_t smem = ReadoutSmem<P, N>::BYTES;
  static bool done[64] = {};
  cudaError_t err = allow_smem(ssd_readout_bf16<P, N>, smem, done);
  if (err != cudaSuccess) return err;
  ssd_readout_bf16<P, N><<<dim3(bh, chunks), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_grads(const BwdParams& p, int blocks, cudaStream_t s) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ssd_state_grads_bf16<P, N>,
                               GradSmem<P, N>::BYTES, done);
  if (err != cudaSuccess) return err;
  ssd_state_grads_bf16<P, N><<<blocks, kThreads, GradSmem<P, N>::BYTES, s>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// fp32: CUDA cores, P and N at run time

namespace f32 {

// The read-out: grid (B * H, L), 16 x 16 threads; thread (ty, tx) owns
// rows ty + 16 i of a row tile and columns tx + 16 j of P.
__global__ void __launch_bounds__(kF32Threads) ssd_readout_f32(const FwdParams p) {
  extern __shared__ float smem[];
  const int P = p.pdim, N = p.ndim, LN = N + 1;
  float* s_e = smem;                    // [P][N + 1]
  float* s_c = s_e + P * LN;            // [kTile][N + 1]
  const int q = p.chunk, chunks = p.seqlen / q;
  const int bh = blockIdx.x, l = blockIdx.y;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int64_t row0 = (int64_t)l * q;
  const float* cp = static_cast<const float*>(p.c) + bi * p.c_sb +
                    hi * p.c_sh + row0 * p.c_ss;
  const float* ep = static_cast<const float*>(p.entering) +
                    ((int64_t)bh * chunks + l) * P * N;
  float* yp = static_cast<float*>(p.y) + bi * p.y_sb + hi * p.y_sh +
              row0 * p.y_ss;
  const float* csp = p.cs + (int64_t)bh * p.seqlen + row0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, pj = P / 16;
  for (int i = threadIdx.x; i < P * N; i += kF32Threads)
    s_e[(i / N) * LN + i % N] = ep[i];
  for (int i0 = 0; i0 < q; i0 += kTile) {
    __syncthreads();                  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * N; i += kF32Threads) {
      const int rr = i / N, k = i % N;
      s_c[rr * LN + k] = i0 + rr < q ? cp[(int64_t)(i0 + rr) * p.c_ss + k]
                                     : 0.f;
    }
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < N; ++k) {
      float cr[4], er[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) cr[i] = s_c[(ty + 16 * i) * LN + k];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        er[j] = j < pj ? s_e[(tx + 16 * j) * LN + k] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cr[i], er[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * i;
      if (row >= q) continue;
      const float sd = expf(csp[row]);
      float* yr = yp + (int64_t)row * p.y_ss;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < pj) yr[tx + 16 * j] = __fadd_rn(yr[tx + 16 * j],
                                                __fmul_rn(acc[i][j], sd));
    }
  }
}

// dE blocks of `ssd_state_grads_f32`: one a (batch, head, chunk, half of P
// when P = 128), thread t holding elements t + 256 i of its prows x N rows of
// dE (row m = e / N).
__device__ __forceinline__ void de_block(const BwdParams& p, int idx,
                                         float* smem) {
  const int P = p.pdim, N = p.ndim, prows = P < kTile ? P : kTile;
  float* s_dy = smem;                   // [kTile][prows]: dy o sd
  float* s_c = s_dy + kTile * prows;       // [kTile][N]
  const int q = p.chunk, chunks = p.seqlen / q;
  const int ph = idx % (P / prows), rest = idx / (P / prows);
  const int l = rest % chunks, bh = rest / chunks;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int g = hi / (p.heads / p.groups), p0 = ph * prows;
  const int64_t row0 = (int64_t)l * q;
  const float* dyb = static_cast<const float*>(p.dy) + bi * p.dy_sb +
                     hi * p.dy_sh + row0 * p.dy_ss;
  const float* cb = static_cast<const float*>(p.c) + bi * p.c_sb +
                    g * p.c_sg + row0 * p.c_ss;
  const float* csp = p.cs + (int64_t)bh * p.seqlen + row0;
  const int elems = prows * N;
  float acc[kF32Elems];
#pragma unroll
  for (int i = 0; i < kF32Elems; ++i) acc[i] = 0.f;
  for (int i0 = 0; i0 < q; i0 += kTile) {
    __syncthreads();                  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * prows; i += kF32Threads) {
      const int rr = i / prows, m = i % prows, j = i0 + rr;
      s_dy[i] = j < q ? dyb[(int64_t)j * p.dy_ss + p0 + m] * expf(csp[j])
                      : 0.f;
    }
    for (int i = threadIdx.x; i < kTile * N; i += kF32Threads) {
      const int rr = i / N, j = i0 + rr;
      s_c[i] = j < q ? cb[(int64_t)j * p.c_ss + i % N] : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < kTile; ++rr) {
#pragma unroll
      for (int i = 0; i < kF32Elems; ++i) {
        const int e = threadIdx.x + kF32Threads * i;
        if (e < elems)
          acc[i] = fmaf(s_dy[rr * prows + e / N], s_c[rr * N + e % N], acc[i]);
      }
    }
  }
  float* out = p.dstates + ((int64_t)bh * chunks + l) * P * N +
               (int64_t)p0 * N;
#pragma unroll
  for (int i = 0; i < kF32Elems; ++i) {
    const int e = threadIdx.x + kF32Threads * i;
    if (e < elems) out[e] = acc[i];
  }
}

// Read-out blocks of `ssd_state_grads_f32`: one a (batch, group, chunk,
// row tile, split of the group's heads), thread t holding elements t + 256
// i of the row tile's 64 x N (row = e / N).
__device__ __forceinline__ void readout_grad_block(const BwdParams& p,
                                                   int idx, float* smem) {
  const int P = p.pdim, N = p.ndim;
  float* s_dy = smem;                   // [kTile][P]
  float* s_e = s_dy + kTile * P;        // [P][N]
  float* s_prod = s_e + P * N;          // [kTile][N]: C o Gr
  float* s_exp = s_prod + kTile * N;    // [kTile]: exp(cs)
  const int q = p.chunk, chunks = p.seqlen / q;
  const int tiles = (q + kTile - 1) / kTile;
  const int split = idx % p.splits, t = (idx / p.splits) % tiles;
  const int rest = idx / p.splits / tiles;
  const int l = rest % chunks, bg = rest / chunks;
  const int bi = bg / p.groups, g = bg % p.groups;
  const int hpg = p.heads / p.groups;
  const int h_lo = g * hpg + split * hpg / p.splits;
  const int h_hi = g * hpg + (split + 1) * hpg / p.splits;
  const int64_t row0 = (int64_t)l * q;
  const int i0 = t * kTile;
  const int elems = kTile * N;
  const float* cb = static_cast<const float*>(p.c) + bi * p.c_sb +
                    g * p.c_sg + row0 * p.c_ss;
  float creg[kF32Elems], dc[kF32Elems];
#pragma unroll
  for (int i = 0; i < kF32Elems; ++i) {
    const int e = threadIdx.x + kF32Threads * i, row = i0 + e / N;
    creg[i] = e < elems && row < q ? cb[(int64_t)row * p.c_ss + e % N] : 0.f;
    dc[i] = 0.f;
  }
  for (int h = h_lo; h < h_hi; ++h) {
    const int64_t bhh = (int64_t)bi * p.heads + h;
    const float* dyp = static_cast<const float*>(p.dy) + bi * p.dy_sb +
                       h * p.dy_sh + row0 * p.dy_ss;
    const float* ep = static_cast<const float*>(p.entering) +
                      (bhh * chunks + l) * P * N;
    const float* csp = p.cs + bhh * p.seqlen + row0;
    __syncthreads();                  // the previous head is consumed
    for (int i = threadIdx.x; i < kTile * P; i += kF32Threads) {
      const int row = i0 + i / P;
      s_dy[i] = row < q ? dyp[(int64_t)row * p.dy_ss + i % P] : 0.f;
    }
    for (int i = threadIdx.x; i < P * N; i += kF32Threads) s_e[i] = ep[i];
    if (threadIdx.x < kTile)
      s_exp[threadIdx.x] = i0 + (int)threadIdx.x < q
                               ? expf(csp[i0 + threadIdx.x]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32Elems; ++i) {
      const int e = threadIdx.x + kF32Threads * i;
      if (e < elems) {
        const int rr = e / N, n = e % N;
        float gr = 0.f;
        for (int k = 0; k < P; ++k)
          gr = fmaf(s_dy[rr * P + k], s_e[k * N + n], gr);
        dc[i] = fmaf(s_exp[rr], gr, dc[i]);
        s_prod[e] = creg[i] * gr;
      }
    }
    __syncthreads();
    if (threadIdx.x < kTile && i0 + (int)threadIdx.x < q) {
      const int rr = threadIdx.x;
      float s = 0.f;
      for (int n = 0; n < N; ++n) s += s_prod[rr * N + n];
      p.dcum[bhh * p.seqlen + row0 + i0 + rr] = s * s_exp[rr];
    }
  }
  float* part = p.dc_part +
                ((((int64_t)split * p.batch + bi) * p.groups + g) * p.seqlen +
                 row0 + i0) * N;
#pragma unroll
  for (int i = 0; i < kF32Elems; ++i) {
    const int e = threadIdx.x + kF32Threads * i;
    if (e < elems && i0 + e / N < q) part[e] = dc[i];
  }
}

__global__ void __launch_bounds__(kF32Threads) ssd_state_grads_f32(const BwdParams p) {
  extern __shared__ float smem[];
  const int tiles = (p.chunk + kTile - 1) / kTile;
  const int readouts = p.batch * p.groups * (p.seqlen / p.chunk) * tiles *
                       p.splits;
  if ((int)blockIdx.x < readouts)
    readout_grad_block(p, blockIdx.x, smem);
  else
    de_block(p, blockIdx.x - readouts, smem);
}

constexpr size_t readout_smem(int P, int N) {
  return sizeof(float) * (size_t)(P + kTile) * (N + 1);
}
constexpr size_t grads_smem(int P, int N) {
  return sizeof(float) * (size_t)(kTile * P + P * N + kTile * N + kTile);
}

cudaError_t launch_fwd(const FwdParams& p, int bh, int chunks,
                       cudaStream_t s) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ssd_readout_f32, readout_smem(128, 128), done);
  if (err != cudaSuccess) return err;
  ssd_readout_f32<<<dim3(bh, chunks), kF32Threads, readout_smem(p.pdim, p.ndim), s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_grads(const BwdParams& p, int blocks, cudaStream_t s) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ssd_state_grads_f32, grads_smem(128, 128), done);
  if (err != cudaSuccess) return err;
  ssd_state_grads_f32<<<blocks, kF32Threads, grads_smem(p.pdim, p.ndim), s>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

template <int P>
cudaError_t fwd_n(const FwdParams& p, int bh, int chunks, cudaStream_t s) {
  switch (p.ndim) {
    case 16: return bf16::launch_fwd<P, 16>(p, bh, chunks, s);
    case 32: return bf16::launch_fwd<P, 32>(p, bh, chunks, s);
    case 64: return bf16::launch_fwd<P, 64>(p, bh, chunks, s);
    case 128: return bf16::launch_fwd<P, 128>(p, bh, chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t fwd_bf16(const FwdParams& p, int bh, int chunks, cudaStream_t s) {
  switch (p.pdim) {
    case 16: return fwd_n<16>(p, bh, chunks, s);
    case 32: return fwd_n<32>(p, bh, chunks, s);
    case 64: return fwd_n<64>(p, bh, chunks, s);
    case 128: return fwd_n<128>(p, bh, chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int P>
cudaError_t grads_n(const BwdParams& p, int blocks, cudaStream_t s) {
  switch (p.ndim) {
    case 16: return bf16::launch_grads<P, 16>(p, blocks, s);
    case 32: return bf16::launch_grads<P, 32>(p, blocks, s);
    case 64: return bf16::launch_grads<P, 64>(p, blocks, s);
    case 128: return bf16::launch_grads<P, 128>(p, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t grads_bf16(const BwdParams& p, int blocks, cudaStream_t s) {
  switch (p.pdim) {
    case 16: return grads_n<16>(p, blocks, s);
    case 32: return grads_n<32>(p, blocks, s);
    case 64: return grads_n<64>(p, blocks, s);
    case 128: return grads_n<128>(p, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

bool dim_ok(int d) { return d == 16 || d == 32 || d == 64 || d == 128; }

// P-tiles of 16, 32 or 64 rows that divide P
bool ptile_ok(int p, int ptile) {
  return (ptile == 16 || ptile == 32 || ptile == 64) && ptile <= p &&
         p % ptile == 0;
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// bf16 rows of 16-byte loads: an aligned start and strides of whole 16
// bytes
bool rows16(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return aligned(ptr, 16) && sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0;
}

bool shape_ok(int batch, int heads, int seqlen, int chunk, int p, int n) {
  return batch > 0 && heads > 0 && chunk > 0 && chunk <= 4096 &&
         seqlen > 0 && seqlen % chunk == 0 && seqlen / chunk <= 65535 &&
         dim_ok(p) && dim_ok(n);
}

}  // namespace

extern "C" {

// Steps 3 and 4 of the chunked SSD: the state pass, then the read-out,
// which adds into y in place.  dtype of y, c and entering: 0 = float32,
// 1 = bfloat16; dt, a, states, init, fin, carries and cs are float32.
// y [B,H,S,P] holds y_diag; states [B,H,L,P,N], [P, N] contiguous and 16-byte
// aligned; dt [B,H,S]; a [B,H]; c [B,H,S,N] (head stride 0 when shared);
// init (or null), fin [B*H,P,N], carries (bfloat16 only, else null) and
// entering [B*H,L,P,N], cs [B*H,S]: dense.  p and n are 16, 32, 64 or 128;
// ptile (16, 32 or 64) divides p.  Strides are in elements, the last
// dimension contiguous.  For bfloat16 the rows of c and y start on 16
// bytes.  Returns the CUDA error of the launches (0 on success).
int repro_ssd_state_fwd(
    void* y, const void* states, const void* dt, const void* a,
    const void* c, const void* init, void* fin, void* carries,
    void* entering, void* cs, int dtype, int batch, int heads, int seqlen,
    int chunk, int p, int n, int ptile,
    int64_t y_sb, int64_t y_sh, int64_t y_ss,
    int64_t st_sb, int64_t st_sh, int64_t st_sl,
    int64_t dt_sb, int64_t dt_sh, int64_t dt_ss,
    int64_t a_sb, int64_t a_sh,
    int64_t c_sb, int64_t c_sh, int64_t c_ss, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (!shape_ok(batch, heads, seqlen, chunk, p, n) || !ptile_ok(p, ptile) ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && carries == nullptr) ||
      !aligned(states, 16) || st_sb % 4 || st_sh % 4 || st_sl % 4 ||
      (init != nullptr && !aligned(init, 16)) || !aligned(fin, 16) ||
      !aligned(entering, 16) || (carries != nullptr && !aligned(carries, 16)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !(rows16(c, c_sb, c_sh, c_ss) &&
                      rows16(y, y_sb, y_sh, y_ss)))
    return (int)cudaErrorMisalignedAddress;
  FwdParams prm;
  prm.y = y; prm.st = static_cast<const float*>(states);
  prm.dt = static_cast<const float*>(dt); prm.a = static_cast<const float*>(a);
  prm.c = c; prm.init = static_cast<const float*>(init);
  prm.fin = static_cast<float*>(fin); prm.carries = static_cast<float*>(carries);
  prm.entering = entering; prm.cs = static_cast<float*>(cs);
  prm.heads = heads; prm.seqlen = seqlen; prm.chunk = chunk;
  prm.pdim = p; prm.ndim = n; prm.ptile = ptile;
  prm.y_sb = y_sb; prm.y_sh = y_sh; prm.y_ss = y_ss;
  prm.st_sb = st_sb; prm.st_sh = st_sh; prm.st_sl = st_sl;
  prm.dt_sb = dt_sb; prm.dt_sh = dt_sh; prm.dt_ss = dt_ss;
  prm.a_sb = a_sb; prm.a_sh = a_sh;
  prm.c_sb = c_sb; prm.c_sh = c_sh; prm.c_ss = c_ss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads, chunks = seqlen / chunk;
  const size_t smem = sizeof(float) * (size_t)(kStage / chunk) * chunk;
  if (dtype == 1)
    ssd_state_pass<T16><<<dim3(bh, p / ptile), kPassThreads, smem, s>>>(prm);
  else
    ssd_state_pass<float><<<dim3(bh, p / ptile), kPassThreads, smem, s>>>(prm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == 1 ? fwd_bf16(prm, bh, chunks, s)
                          : f32::launch_fwd(prm, bh, chunks, s));
}

// The backward of repro_ssd_state_fwd given dy [B,H,S,P] (the dtype's) and
// dfinal [B*H,P,N] (float32, or null for zero): the products (dE into
// dstates, dcs, each head split's dc), then the walk.  carries (float32;
// for float32 the entering states), entering and cs as the forward wrote
// them; c [B,G,S,N] with G = 1 or heads (group stride c_sg).  Writes
// dstates [B*H,L,P,N], dinit [B*H,P,N] (unless null), dcum [B*H,S] and
// dc_part [splits,B,G,S,N] (each split of a group's heads its sum), and,
// for splits > 1, dc [B,G,S,N], the splits added in order; all float32 and
// dense.  splits in [1, heads / groups].  For bfloat16 the rows of dy and c
// start on 16 bytes.  Returns the CUDA error of the launches (0 on
// success).
int repro_ssd_state_bwd(
    const void* dy, const void* dfinal, const void* carries,
    const void* entering, const void* cs, const void* c, void* dstates,
    void* dinit, void* dcum, void* dc_part, void* dc, int dtype, int batch,
    int heads, int groups, int seqlen, int chunk, int p, int n, int splits,
    int64_t dy_sb, int64_t dy_sh, int64_t dy_ss,
    int64_t c_sb, int64_t c_sg, int64_t c_ss, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (!shape_ok(batch, heads, seqlen, chunk, p, n) ||
      (dtype != 0 && dtype != 1) || (groups != 1 && groups != heads) ||
      splits < 1 || splits > heads / groups)
    return (int)cudaErrorInvalidValue;
  const int chunks = seqlen / chunk, tiles = (chunk + kTile - 1) / kTile;
  const int64_t blocks = (int64_t)batch * groups * chunks * tiles * splits +
                         (int64_t)batch * heads * chunks * (p > 64 ? 2 : 1);
  if (blocks > 0x7fffffff || !aligned(carries, 16) || !aligned(dstates, 16) ||
      (dfinal != nullptr && !aligned(dfinal, 16)) ||
      (dinit != nullptr && !aligned(dinit, 16)) || !aligned(dc_part, 16) ||
      (splits > 1 && !aligned(dc, 16)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !(rows16(dy, dy_sb, dy_sh, dy_ss) &&
                      rows16(c, c_sb, c_sg, c_ss) && aligned(entering, 16)))
    return (int)cudaErrorMisalignedAddress;
  BwdParams prm;
  prm.dy = dy; prm.dfinal = static_cast<const float*>(dfinal);
  prm.carries = static_cast<const float*>(carries); prm.entering = entering;
  prm.cs = static_cast<const float*>(cs); prm.c = c;
  prm.dstates = static_cast<float*>(dstates);
  prm.dinit = static_cast<float*>(dinit);
  prm.dcum = static_cast<float*>(dcum);
  prm.dc_part = static_cast<float*>(dc_part);
  prm.dc = static_cast<float*>(dc);
  prm.batch = batch; prm.heads = heads; prm.groups = groups;
  prm.seqlen = seqlen; prm.chunk = chunk; prm.pdim = p; prm.ndim = n;
  prm.splits = splits;
  prm.dy_sb = dy_sb; prm.dy_sh = dy_sh; prm.dy_ss = dy_ss;
  prm.c_sb = c_sb; prm.c_sg = c_sg; prm.c_ss = c_ss;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? grads_bf16(prm, (int)blocks, s)
                               : f32::launch_grads(prm, (int)blocks, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t dc_elems = (int64_t)batch * groups * seqlen * n;
  const int sums = splits > 1 ? (int)((dc_elems / 4 + kWalkThreads - 1) /
                                      kWalkThreads)
                              : 0;
  ssd_state_walk<<<batch * heads + sums, kWalkThreads, 0, s>>>(prm);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
