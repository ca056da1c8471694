// Hopper (sm_90a) building blocks in inline PTX, shared by the port's
// tensor-core kernels: 16-byte cp.async with zero fill, the async-proxy
// fence, the 32/64/128-byte shared-memory swizzle that wgmma's descriptors
// name, the descriptors themselves, and warpgroup matrix products
// (wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators) with A from
// shared memory or from registers.  No CUTLASS or CuTe: every layout rule
// used here is written out below.
//
// Operand layouts (the PTX ISA's canonical wgmma layouts).  A tile of bf16
// rows is stored as column blocks of CB = W / 2 elements (W = 32, 64 or 128
// bytes, the swizzle width); block c holds every row's elements
// [c*CB, (c+1)*CB), rows W bytes apart, and blocks follow each other.  The
// swizzle XORs address bits [7, 7 + log2(W/16)) into the 16-byte chunk bits
// [4, ...), on absolute shared-memory addresses, so every tile starts on a
// 1024-byte boundary.
//   K-major operand (rows = M or N, K along the row), e.g. Q or K for Q.K^T:
//     stride byte offset (SBO) = 8 rows = 8 W; leading offset unused; the
//     k-th 16-wide step starts (16 k / CB) blocks on, at byte 32 k mod W.
//   MN-major operand (rows = K, N along the row), e.g. V for P.V
//     (transpose bit set): SBO = 8 rows = 8 W; leading byte offset (LBO) =
//     the distance between column blocks; the k-th step starts 16 k rows on.
//
// Fragments of one warpgroup (128 threads; warp w, lane l; g = l / 4 and
// c = l % 4).  The m64nN f32 accumulator d[N/2]: d[4i + e] is row
// 16 w + g + 8 (e / 2), column 8 i + 2 c + (e % 2).  The m64k16 bf16 A
// operand in registers, a[4] of bf16 pairs: a[j] holds row 16 w + g + 8 (j % 2),
// columns 8 (j / 2) + 2 c and + 1 (low half first).  So the accumulator
// columns [16 k, 16 k + 16) packed in order, d[8k .. 8k+7] two at a time,
// are the A operand of the k-th step of a following product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (all 16 when src_bytes = 0, then src is not read) become zero.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the front-end compiler from moving reads and writes of accumulator
// registers across wgmma_fence and wgmma_wait (it sees the product as a
// synchronous write; ptxas orders wgmma's register accesses itself).  The
// uint32_t form is for an A operand in registers, which wgmma reads
// asynchronously too: after the wait, it keeps the values live until then.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// Byte offset `off` within a W-byte-swizzled tile (see the top of the file).
template <int W>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  static_assert(W == 32 || W == 64 || W == 128, "swizzle width");
  return off ^ ((off >> 3) & ((W / 16 - 1) << 4));
}

// A [ROWS, D] bf16 tile in the layout above: column blocks of CB elements,
// W bytes per row of a block.
template <int D>
struct TileShape {
  static constexpr int CB = D < 64 ? D : 64;
  static constexpr int W = 2 * CB;
};

// One thread's share of loading such a tile with THREADS threads: 16-byte
// chunk `chunk` of rows `row`, row + STEP, ...; `soff` is the first one's
// swizzled offset in a tile of 64 rows (STEP rows cover whole swizzle
// atoms, so only the distance between column blocks depends on ROWS).
template <int D, int THREADS>
struct TileLoader {
  static constexpr int CHUNKS = D / 8;            // 16-byte chunks per row
  static constexpr int STEP = THREADS / CHUNKS;   // rows apart
  static constexpr int CB = TileShape<D>::CB, W = TileShape<D>::W;
  int row, chunk;
  uint32_t soff;

  // byte offset of chunk c of row r in a tile of ROWS rows
  template <int ROWS>
  __device__ __forceinline__ static uint32_t offset(int r, int c) {
    return (c / (CB / 8)) * (ROWS * W) +
           swizzle<W>(r * W + (c % (CB / 8)) * 16);
  }

  __device__ __forceinline__ explicit TileLoader(int tid)
      : row(tid / CHUNKS), chunk(tid % CHUNKS),
        soff(offset<64>(tid / CHUNKS, tid % CHUNKS)) {}

  // Rows [row0, row0 + ROWS) of a [S, D] slice (row stride `stride`) into
  // the tile at `dst`, rows at or past `limit` zero-filled (not read).
  template <int ROWS>
  __device__ __forceinline__ void load(uint32_t dst, const __nv_bfloat16* src,
                                       int64_t stride, int row0,
                                       int limit) const {
    static_assert(ROWS % STEP == 0 && STEP * W % 1024 == 0,
                  "tile load split");
    const __nv_bfloat16* g = src + (int64_t)(row0 + row) * stride + chunk * 8;
    const int64_t step = (int64_t)STEP * stride;
    dst += soff + (chunk / (CB / 8)) * ((ROWS - 64) * W);
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const bool in = row0 + row + i * STEP < limit;
      cp_async_16(dst + i * STEP * W, in ? g : src, in ? 16 : 0);
      g += step;
    }
  }
};

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each), swizzle mode (1 = 128 B, 2 = 64 B,
// 3 = 32 B) in bits 62-63; base offset 0 (tiles are 1024-byte aligned).
template <int W>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t mode = W == 128 ? 1 : W == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two halves of a packed bf16 pair as floats
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 2**x (MUFU.EX2; -inf gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator operand lists for the wgmma wrappers below: inline PTX takes
// numbered operands only, so each width's list is written out.
#define HOPPER_F8(d, i)                                                   \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HOPPER_F32(d, i) \
  HOPPER_F8(d, i), HOPPER_F8(d, (i) + 8), HOPPER_F8(d, (i) + 16), \
      HOPPER_F8(d, (i) + 24)
#define HOPPER_D8(d) HOPPER_F8(d, 0)
#define HOPPER_D16(d) HOPPER_F8(d, 0), HOPPER_F8(d, 8)
#define HOPPER_D32(d) HOPPER_F32(d, 0)
#define HOPPER_D64(d) HOPPER_F32(d, 0), HOPPER_F32(d, 32)
#define HOPPER_D128(d) \
  HOPPER_F32(d, 0), HOPPER_F32(d, 32), HOPPER_F32(d, 64), HOPPER_F32(d, 96)

// D[64 x N] (+)= A[64 x 16] . B[16 x N], bf16 x bf16 -> f32, issued by one
// warpgroup; scale_d = 0 ignores D's old value.  `ss`: A and B by shared-
// memory descriptor, A K-major.  `rs`: A from registers (the layout at the
// top).  TransB = 0: B K-major; 1: B MN-major.  Call between wgmma_fence()
// and wgmma_commit(); the result is there after wgmma_wait.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static constexpr int kRegs = 8;
  template <int TransB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : HOPPER_D8(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  template <int TransB>
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : HOPPER_D8(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <>
struct Wgmma<32> {
  static constexpr int kRegs = 16;
  template <int TransB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : HOPPER_D16(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  template <int TransB>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : HOPPER_D16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <>
struct Wgmma<64> {
  static constexpr int kRegs = 32;
  template <int TransB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : HOPPER_D32(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  template <int TransB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int kRegs = 64;
  template <int TransB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : HOPPER_D64(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  template <int TransB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOPPER_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};

template <>
struct Wgmma<256> {
  static constexpr int kRegs = 128;
  template <int TransB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : HOPPER_D128(d)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
  }
  template <int TransB>
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : HOPPER_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TransB));
  }
};


}  // namespace hopper
