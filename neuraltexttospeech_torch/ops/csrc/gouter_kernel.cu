// Tap-window grouped GEMM for Hopper (sm_90a): the MSD's folded grouped conv
// on the tensor cores, in two element forms: f32-accurate by 3xTF32, and
// bf16 with f32 accumulation, each a kernel of its own.
//
// Replaces neuraltexttospeech_tpu/ops/gouter_kernel.py::gouter_tap_dots_pallas
// (pallas_call at :114, body :105-112), which takes f32 or bf16 operands,
// sums every product in f32 and rounds to the operands' type once. For
// xp [g, B, Qp, X] and wf [kf, g, X, Y] it computes
//
//   y[g, b, t, :] = sum_{mf < kf} xp[g, b, mf*s + t, :] @ wf[mf, g, :, :]
//
// for t < q: per group a GEMM of M = B*q rows by N = Y columns over
// K = kf*X, whose A row (b, t) at tap mf is the shifted window row
// xp[g, b, mf*s + t], addressed in place. The backward's dx is the same
// function on zero-padded dy with the weights flipped over the taps and
// transposed (nn/fastconv.py); `flip_t` selects that form, so one kernel
// serves both.
//
// What bounds it on the card: at the v1 MSD shapes a call does
// 2*g*B*q*kf*X*Y FLOP against (xp + wf + y) bytes, 70-500 FLOP per byte in
// f32 and twice that in bf16. In f32 every shape is bound by operations; in
// bf16 half of the shapes (the short third-scale ones and those with 21 or
// 5 taps of 128 values, whose weights are as large as their activations)
// are bound by bytes, and all of them are small: 2-30 us of work each.
// - f32 (Tf32x3): the GAN tolerances rule out one-pass TF32 or bf16, and f32
//   FMAs on the CUDA cores stop at 67 TFLOP/s. So each f32 operand is split
//   into hi = tf32(a) and lo = tf32(a - hi) (round to nearest, ties away),
//   and lo*hi + hi*lo + hi*hi (small terms first) runs on the TF32 tensor
//   cores (495 TFLOP/s dense, so about 165 TFLOP/s of f32-accurate work),
//   about 2^-22 relative per product. The tensor cores' accumulator does not
//   round to nearest, so each K block of 32 sums into a fresh wgmma
//   accumulator that is then added to an f32 register accumulator.
// - bf16: one wgmma .bf16 product per K step (989 TFLOP/s dense); a bf16
//   product is exact in f32. The whole K sums in the one wgmma accumulator:
//   its truncating adds lose at most 2^-23 of the running sum each, one add
//   per 16 products, so at the largest K (21 taps x 512 = 672 adds) under
//   2^-13 of the largest partial sum, a small fraction of the 2^-9 that the
//   once-rounded bf16 output is allowed. The order of K is (chunk of X, tap);
//   the bound does not depend on it.
//
// Both forms start with a prologue kernel that writes the weights K-major,
// [parts, kf, g, K/kBK, n, kBK] (kBK = 32 f32 split into hi and lo, or 64
// bf16 in one part), each 128-byte row already in the 128-byte swizzle that
// wgmma reads, so a B tile (one tap, one K block, BN columns) is one
// contiguous block that a bulk async copy (the TMA unit) moves into shared
// memory. The wrapper picks the tile per call; where the tiles give fewer
// blocks than SMs, K may be split over the blocks and a second kernel adds
// the f32 partial sums in a fixed order (deterministic, no atomics), rounding
// to bf16 after the sum.
//
// f32 (tap_dots_tc_kernel<Tf32x3>): one or two consumer warpgroups of 64 rows;
// K walks (tap mf, 32 values of X). A ring of 4 shared-memory stages, each
// filled by 16-byte cp.async gathers of the shifted window rows (rows cross
// batch boundaries at any q; rows past B*q read zeros) and the bulk copies of
// the hi and lo B tiles, completes on an mbarrier per stage; loads run two
// stages ahead. A goes from shared memory (rows padded against bank
// conflicts) to registers, is split there, and feeds wgmma m64nNk8 .tf32
// from registers.
//
// bf16 (window_taps_bf16_kernel): the ring gathered each A row once per tap,
// kf = 3-21 times, and waited for each stage's wgmmas before the next. Here:
// - Window reuse. For each unit of K (64 values of X, a group of taps, all kf
//   of them where the window fits) three producer warps load the block's A
//   window once, by 16-byte cp.asyncs of the rows the taps read, batch
//   segment after segment, into one of three buffers with a 144-byte row
//   pitch; the fourth streams one B tile per tap through a bulk-copy ring
//   of 6 to 12 stages, as many as the windows leave room for. A window of a
//   128-row tile is 128 + (segments)*(kf-1)*s rows: at most 288 at the v1
//   shapes, against 128*kf gathered rows before.
// - A from registers. The row a tap reads is (r - m0) + seg(r)*span + mf*s,
//   not a multiple of 8 rows, so no swizzled descriptor can address it:
//   each lane gives ldmatrix its own row's address, and wgmma m64nNk16 takes
//   A from registers, B by descriptor.
// - Warp specialisation. One producer warpgroup (setmaxnreg down to 56) and
//   one or two consumer warpgroups (224) that only ldmatrix and wgmma, each
//   over one or two 64-row tiles. A consumer keeps one wgmma group in flight
//   and frees a B stage, or a window, once the group that read it is done;
//   windows are triple-buffered, so the next units' loads overlap this
//   one's products.
// - Tiles of 256, 128 or 64 rows by 128 columns, K splits over units, and
//   taps per unit are the wrapper's plan (ops/gouter_kernel.py); 64-column
//   tiles measured no faster (within 2 %) at any v1 shape.
// What bounds it now (measured on an H100 by clock64 stamps in each block):
// a 128x128 tile waits for its weight tiles about 30 % of the time (a 16 KB
// tile from L2 for every 2 MFLOP), a 256x128 tile about 6 %; between the
// waits the tensor cores run at 76-87 % of their rate; the short calls
// leave most of the card idle. Tried and dropped: a 128-byte bulk copy per window row
// (the TMA unit takes them far too slowly: the consumers waited on windows
// half the time), and the weights read in place by cp.async into the
// swizzle, K-major or MN-major (no prologue, but the weight stream then
// starved the consumers: 1.07-1.22 ms over the v1 shapes against 0.97).

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 4;    // shared-memory ring
constexpr int kAhead = 2;     // blocks loaded ahead of the one computed
constexpr int kRowBytes = 128;  // one K block of one row: a 128-byte swizzle row

// The two element forms. kBK: K per stage (one 128-byte row); kParts: B
// tiles per stage; kARowBytes: bytes per A row in shared memory.
struct Tf32x3 {
  using T = float;
  static constexpr int kBK = 32;
  static constexpr int kParts = 2;        // hi, lo
  static constexpr int kARowBytes = 144;  // 36 floats: 32 + 4, no bank conflicts
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero; the
// low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait that traps (a launch error) instead of spinning for ever if the
// phase has not completed after about 2^32 cycles, seconds: a pipeline
// fault surfaces as an error, not a hung card.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// Contiguous bulk copy global -> shared by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO); LBO is unused there.
__device__ __forceinline__ uint64_t b128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Orders the compiler's uses of registers that an in-flight wgmma reads or
// writes after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[i][j]));
}

// d[32] (+)= A[64x8] (registers) * B[8x64] (K-major, 128 B swizzled, in shared
// memory at desc); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[64] (+)= A[64x8] (registers) * B[8x128] (K-major, 128 B swizzled, in shared
// memory at desc); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[32] (+)= A[64x16] (bf16 in registers, the m16n8k16 A fragment per warp)
// * B[16x64] (bf16, K-major, 128 B swizzled, in shared memory at desc);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[64] (+)= A[64x16] (bf16 in registers, the m16n8k16 A fragment per warp)
// * B[16x128] (bf16, K-major, 128 B swizzled, in shared memory at desc);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  if constexpr (BN == 128) wgmma_m64n128k16_bf16_rs(d, a, desc, scale_d);
  else wgmma_m64n64k16_bf16_rs(d, a, desc, scale_d);
}

// Four 8x8 b16 matrices from shared memory, lane l giving the address of row
// l % 8 of matrix l / 8: r[i] holds row (lane / 4), columns 2*(lane % 4) and
// +1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Waits until at most one wgmma group of this warpgroup is in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (BN == 128) wgmma_m64n128k8(d, a, desc, scale_d);
  else wgmma_m64n64k8(d, a, desc, scale_d);
}

// Byte offset of 16-byte chunk c of A row r in a shared-memory stage.
template <class E>
__device__ __forceinline__ uint32_t a_chunk_offset(int r, int c) {
  return r * E::kARowBytes + (c << 4);
}

struct TapArgs {
  const void* xp;  // [g, batch, qp, kc] of E::T
  const void* wk;  // [parts, kf, g, kc/kBK, n, kBK] of E::T, rows swizzled (the prologue's output)
  float* out;      // [splits, g, batch*q, n] partial sums, or y [g, batch*q, n]
  int g, batch, qp, kc, n, kf, s, q, kb_per_split, n_kb;
};

template <class E, int NWG, int BN>
constexpr int smem_bytes() {
  return kStages * (E::kParts * BN * kRowBytes + NWG * 64 * E::kARowBytes) + 2 * kStages * 8 +
         1024;
}

template <class E, int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128) tap_dots_tc_kernel(const TapArgs args) {
  using T = typename E::T;
  constexpr int kThreads = NWG * 128;
  constexpr int kBM = NWG * 64;
  constexpr int kBK = E::kBK;
  constexpr int kBTile = BN * kRowBytes;          // bytes of one B tile (one part)
  constexpr int kAStage = kBM * E::kARowBytes;    // bytes of one A tile
  constexpr int kAChunks = kBM * 8 / kThreads;    // 16-byte chunks a thread gathers
  constexpr int kAcc = BN / 2;                    // accumulator floats per thread

  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle is a function of the shared address
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t b_base = smem_u32(smem);  // stage st, part h at +(parts*st + h)*kBTile
  const uint32_t a_base = b_base + kStages * E::kParts * kBTile;
  const unsigned char* a_smem = smem + kStages * E::kParts * kBTile;
  const uint32_t full_bar = a_base + kStages * kAStage;  // kStages x 8 bytes
  const uint32_t empty_bar = full_bar + kStages * 8;

  const int tid = threadIdx.x;
  const int m_total = args.batch * args.q;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int gi = blockIdx.z % args.g, split = blockIdx.z / args.g;
  const int kb_begin = split * args.kb_per_split;
  const int nk = min(args.n_kb, kb_begin + args.kb_per_split) - kb_begin;
  const int kc_blocks = args.kc / kBK;
  const size_t row_bytes = static_cast<size_t>(args.kc) * sizeof(T);

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, kThreads + 1);  // every thread's cp.asyncs + the bulk copies
      mbar_init(empty_bar + 8 * st, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // This thread's window rows: chunk (tid & 7) of rows (tid >> 3) + i*kThreads/8.
  const unsigned char* xp = static_cast<const unsigned char*>(args.xp);
  const unsigned char* a_src[kAChunks];
  uint32_t a_bytes[kAChunks], a_dst[kAChunks];
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int r = (tid >> 3) + i * (kThreads / 8), m = m0 + r;
    a_bytes[i] = m < m_total ? 16 : 0;
    a_src[i] = xp;
    if (m < m_total) {
      const int b = m / args.q, t = m % args.q;
      a_src[i] = xp + ((static_cast<size_t>(gi) * args.batch + b) * args.qp + t) * row_bytes +
                 (tid & 7) * 16;
    }
    a_dst[i] = a_chunk_offset<E>(r, tid & 7);
  }

  const unsigned char* wk = static_cast<const unsigned char*>(args.wk);
  auto load = [&](int i, int st) {
    const int kb = kb_begin + i;
    const int mf = kb / kc_blocks, kx = kb % kc_blocks;
    const size_t a_off = (static_cast<size_t>(mf) * args.s * args.kc + kx * kBK) * sizeof(T);
#pragma unroll
    for (int c = 0; c < kAChunks; ++c)
      cp_async_16(a_base + st * kAStage + a_dst[c], a_bytes[c] ? a_src[c] + a_off : a_src[c],
                  a_bytes[c]);
    cp_async_arrive(full_bar + 8 * st);
    if (tid == 0) {
      mbar_arrive_expect_tx(full_bar + 8 * st, E::kParts * kBTile);
#pragma unroll
      for (int h = 0; h < E::kParts; ++h) {
        const size_t row0 =
            (((static_cast<size_t>(h) * args.kf + mf) * args.g + gi) * kc_blocks + kx) * args.n +
            n0;
        bulk_copy(b_base + (E::kParts * st + h) * kBTile, wk + row0 * kRowBytes, kBTile,
                  full_bar + 8 * st);
      }
    }
  };

  // A fragment of m64n*k8 .tf32: a[e] is row ar + 8*(e & 1), column ac + 4*(e >> 1).
  const int ar = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + (tid % 32) / 4;
  const int ac = tid % 4;
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = part[e] = 0.f;

  for (int i = 0; i < min(kAhead, nk); ++i) load(i, i);
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    const int next = i + kAhead;
    if (next < nk) {
      const int sn = next % kStages;
      if (next >= kStages) mbar_wait(empty_bar + 8 * sn, (next / kStages - 1) & 1);
      load(next, sn);
    }
    mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
    const uint32_t b_st = b_base + E::kParts * st * kBTile;

    uint32_t hi[4][4], lo[4][4];
    const float* as = reinterpret_cast<const float*>(a_smem + st * kAStage);
    constexpr int kAStride = E::kARowBytes / 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = as[(ar + 8 * (e & 1)) * kAStride + kk * 8 + ac + 4 * (e >> 1)];
        hi[kk][e] = tf32_rna(v);
        lo[kk][e] = tf32_rna(v - __uint_as_float(hi[kk][e]));
      }
    const uint32_t b_hi = b_st, b_lo = b_hi + kBTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // the small terms first, into a fresh accumulator
      wgmma_tf32<BN>(part, lo[kk], b128_desc(b_hi + kk * 32), kk > 0);
      wgmma_tf32<BN>(part, hi[kk], b128_desc(b_lo + kk * 32), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32<BN>(part, hi[kk], b128_desc(b_hi + kk * 32), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    keep_regs(hi);
    keep_regs(lo);
    mbar_arrive(empty_bar + 8 * st);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] += part[e];
  }

  // Accumulator of m64nN: acc[4j + v] is row ar + 8*(v >> 1), column 8j + 2*ac + (v & 1).
  const size_t out0 = (static_cast<size_t>(split) * args.g + gi) * m_total * args.n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * ac;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + ar + 8 * h;
      if (m >= m_total) continue;
      const size_t at = out0 + static_cast<size_t>(m) * args.n + col;
      *reinterpret_cast<float2*>(args.out + at) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// y = sum over the K splits of partial (f32), in order of the split, then
// stored as OutT (a bf16 y is rounded once, after the sum).
template <typename OutT>
__global__ void sum_splits_kernel(const float4* __restrict__ partial, OutT* __restrict__ y,
                                  int splits, size_t n4) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n4) return;
  float4 s = partial[idx];
  for (int z = 1; z < splits; ++z) {
    const float4 p = partial[z * n4 + idx];
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  if constexpr (std::is_same_v<OutT, float>) {
    reinterpret_cast<float4*>(y)[idx] = s;
  } else {
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y) + 2 * idx;
    out[0] = __floats2bfloat162_rn(s.x, s.y);
    out[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

// The weights as wgmma's B operand: B[n][k] of tap mf, group gi is
// wf[mf, gi, k, n] (forward) or wf[kf-1-mf, gi, n, k] (flip_t, the dx form),
// stored [parts, kf, g, kc/kBK, n, kBK] with the 16-byte chunk c of row n
// at chunk c ^ (n % 8): f32 split into TF32 hi and lo (two parts). One block
// per kBK x 32 tile. (The bf16 form's is pack_weights_kernel_bf16.)
template <class E>
__global__ void pack_weights_kernel(const typename E::T* __restrict__ wf,
                                    typename E::T* __restrict__ wk, int kf, int g, int kc, int n,
                                    int flip_t) {
  using T = typename E::T;
  constexpr int kBK = E::kBK;
  constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte chunk
  __shared__ float tile[kBK][33];         // [k][n]
  const int n0 = blockIdx.x * 32, kx = blockIdx.y;
  const int mf = blockIdx.z / g, gi = blockIdx.z % g;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (!flip_t) {
    const T* src = wf + (static_cast<size_t>(mf) * g + gi) * kc * n;  // [kc, n]
    for (int k = ty; k < kBK; k += 8)
      tile[k][tx] = static_cast<float>(src[static_cast<size_t>(kx * kBK + k) * n + n0 + tx]);
  } else {
    const T* src = wf + (static_cast<size_t>(kf - 1 - mf) * g + gi) * n * kc;  // [n, kc]
    for (int r = ty; r < 32; r += 8)
      for (int k = tx; k < kBK; k += 32)
        tile[k][r] = static_cast<float>(src[static_cast<size_t>(n0 + r) * kc + kx * kBK + k]);
  }
  __syncthreads();
  const int kc_blocks = kc / kBK;
  for (int r = ty; r < 32; r += 8) {
    const int row = n0 + r;
    for (int k = tx; k < kBK; k += 32) {
      const float v = tile[k][r];
      const int col = (((k / kChunk) ^ (row & 7)) * kChunk) | (k % kChunk);
      const size_t at = ((static_cast<size_t>(mf) * g + gi) * kc_blocks + kx) * n + row;
      const uint32_t hi = tf32_rna(v);
      const uint32_t lo = tf32_rna(v - __uint_as_float(hi));
      const size_t part = static_cast<size_t>(kf) * g * kc_blocks * n * kBK;
      wk[at * kBK + col] = __uint_as_float(hi);
      wk[part + at * kBK + col] = __uint_as_float(lo);
    }
  }
}

// The bf16 form's prologue: the same [kf, g, kc/64, n, 64] layout in one
// part, by 64 x 64 tiles moved in 16-byte loads and stores. In the dx form
// (flip_t) a row of B is already 64 contiguous values of wf: its chunks are
// only permuted; in the forward a tile goes through shared memory transposed.
__global__ void __launch_bounds__(256) pack_weights_kernel_bf16(const uint4* __restrict__ wf,
                                                                uint4* __restrict__ wk, int kf,
                                                                int g, int kc, int n, int flip_t) {
  __shared__ __nv_bfloat16 tile[64][66];  // [k][n], padded against bank conflicts
  const int n0 = blockIdx.x * 64, kx = blockIdx.y;
  const int mf = blockIdx.z / g, gi = blockIdx.z % g;
  const size_t row0 = ((static_cast<size_t>(mf) * g + gi) * (kc / 64) + kx) * n + n0;
  if (flip_t) {
    const uint4* src = wf + ((static_cast<size_t>(kf - 1 - mf) * g + gi) * n + n0) * (kc / 8);
    for (int e = threadIdx.x; e < 64 * 8; e += 256) {
      const int r = e / 8, c = e % 8;
      wk[(row0 + r) * 8 + (c ^ ((n0 + r) & 7))] =
          src[static_cast<size_t>(r) * (kc / 8) + kx * 8 + c];
    }
    return;
  }
  const uint4* src = wf + ((static_cast<size_t>(mf) * g + gi) * kc + kx * 64) * (n / 8) + n0 / 8;
  for (int e = threadIdx.x; e < 64 * 8; e += 256) {
    const int k = e / 8, c = e % 8;
    const uint4 v = src[static_cast<size_t>(k) * (n / 8) + c];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) tile[k][8 * c + i] = h[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 8; e += 256) {
    const int r = e / 8, c = e % 8;  // row n0 + r, values 8c .. 8c + 7 of K
    uint4 v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = tile[8 * c + i][r];
    wk[(row0 + r) * 8 + (c ^ ((n0 + r) & 7))] = v;
  }
}

// ------------------------------------------------------------ bf16 form
//
// One block computes a tile of BM = 64*NWG output rows m0.. (of the B*q
// rows) by 128 columns of one group. Its K runs over units (X chunk kx of 64
// values, tap group): for each unit the producer loads the block's A window
// once, the rows of xp that the unit's taps mf0 .. mf0 + taps - 1 read, and
// streams one B tile per tap; the consumers run every tap against the window.
//
// The window packs the tile's batch segments one after another: segment b
// (output rows t_lo..t_hi of utterance b) brings xp rows b*Qp + t_lo + mf0*s
// onwards, t_hi - t_lo + 1 + span of them, span = (taps - 1)*s. So output row
// r = b*q + t at tap mf reads window row
//
//   (r - m0) + (b - m0 / q) * span + (mf - mf0) * s
//
// (ops/gouter_kernel.py::window_row mirrors it), and a window holds
// (rows of the tile) + (segments) * span rows, however large Qp is.

constexpr int kWinPitch = 144;  // bytes per window row: 128 + 16, no ldmatrix bank conflicts
constexpr int kWinBN = 128;     // tile columns
constexpr int kBStages = 6;      // B ring: at least 6 tiles of 16 KB,
constexpr int kMaxBStages = 12;  // and as many more as the windows leave room for
constexpr int kWinBufs = 3;     // windows: the next two units load while one is computed
constexpr int kWinLoaders = 96;  // threads that load windows: producer warps 0, 2 and 3
constexpr int kMaxSmem = 232448;

struct WinArgs {
  const __nv_bfloat16* xp;  // [g, batch, qp, kc]
  const __nv_bfloat16* wk;  // [kf, g, kc/64, n, 64], rows swizzled (the prologue's output)
  void* out;                // [splits, g, batch*q, n] f32 partial sums, or bf16 y [g, batch*q, n]
  int g, batch, qp, kc, n, kf, s, q;
  int taps_per_group, n_groups, units_per_split, n_units;
  int win_rows;  // rows one window buffer holds
  int b_stages;  // tiles in the B ring
  int out_bf16;
};

constexpr int kWinBarriers = (2 * kMaxBStages + 2 * kWinBufs) * 8;

// B stages that fit beside the windows (kBStages .. kMaxBStages), or 0.
int window_b_stages(int win_rows) {
  const int room = kMaxSmem - 1024 - kWinBarriers - kWinBufs * win_rows * kWinPitch;
  const int stages = min(kMaxBStages, room / (kWinBN * kRowBytes));
  return stages < kBStages ? 0 : stages;
}

// The most window rows any tile of bm rows needs at this span.
int window_rows_needed(int m_total, int q, int bm, int span) {
  int most = 0;
  for (int m0 = 0; m0 < m_total; m0 += bm) {
    const int m_end = min(m0 + bm, m_total);
    most = max(most, m_end - m0 + ((m_end - 1) / q - m0 / q + 1) * span);
  }
  return most;
}

// One tap of the bf16 kernel: A (MT tiles of 64 rows x 64 values of X) from
// the window into registers, 4*MT wgmma k16 steps against the tap's B tile
// once it has landed, committed as one group; returns when the previous
// group is done.
template <int MT>
__device__ __forceinline__ void window_tap(float (&acc)[MT][kWinBN / 2], uint32_t (&a)[MT][4][4],
                                           const uint32_t (&a_addr)[MT], uint32_t b_full,
                                           uint32_t parity, uint32_t b_tile) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[mt][kk], a_addr[mt] + kk * 32);  // 16 bf16 = 32 B
  mbar_wait_bounded(b_full, parity);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      wgmma_bf16_rs<kWinBN>(acc[mt], a[mt][kk], b128_desc(b_tile + kk * 32), 1);
  wgmma_commit();
  wgmma_wait_one();
}

template <int NWG, int MT>
__global__ void __launch_bounds__((NWG + 1) * 128, 1) window_taps_bf16_kernel(const WinArgs args) {
  constexpr int BN = kWinBN;
  constexpr int kBM = NWG * MT * 64;
  constexpr int kBTile = BN * kRowBytes;
  constexpr int kAcc = BN / 2;

  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the B tiles' swizzle is a function of the shared address
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int b_stages = args.b_stages;
  const uint32_t b_base = smem_u32(smem);  // B stage st at + st*kBTile
  const uint32_t w_base = b_base + b_stages * kBTile;
  const uint32_t win_bytes = args.win_rows * kWinPitch;  // window buffer w at + w*win_bytes
  const uint32_t b_full = w_base + kWinBufs * win_bytes;  // b_stages x 8 bytes each
  const uint32_t b_empty = b_full + 8 * kMaxBStages;
  const uint32_t w_full = b_empty + 8 * kMaxBStages;  // kWinBufs x 8 bytes each
  const uint32_t w_empty = w_full + 8 * kWinBufs;

  const int m_total = args.batch * args.q;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int m_end = min(m0 + kBM, m_total);
  const int gi = blockIdx.z % args.g, split = blockIdx.z / args.g;
  const int u_begin = split * args.units_per_split;
  const int u_end = min(args.n_units, u_begin + args.units_per_split);
  const int kc_blocks = args.kc / 64;

  if (threadIdx.x == 0) {
    for (int st = 0; st < b_stages; ++st) {
      mbar_init(b_full + 8 * st, 1);  // the producer's expect_tx; the copy's bytes
      mbar_init(b_empty + 8 * st, NWG);
    }
    for (int w = 0; w < kWinBufs; ++w) {
      mbar_init(w_full + 8 * w, kWinLoaders);  // every loader's cp.asyncs
      mbar_init(w_empty + 8 * w, NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == NWG) {  // the producer warpgroup: warps 0, 2, 3 windows, warp 1 B
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const size_t row_bytes = static_cast<size_t>(args.kc) * 2;
    if (warp != 1) {
      // 16-byte cp.asyncs, one thread a chunk in turn over the window's rows;
      // bulk copies of single 128-byte rows queue on the TMA unit far slower
      const int lt = (warp == 0 ? 0 : warp - 1) * 32 + lane;
      const unsigned char* xg = reinterpret_cast<const unsigned char*>(args.xp) +
                                static_cast<size_t>(gi) * args.batch * args.qp * row_bytes;
      const int b_first = m0 / args.q, b_last = (m_end - 1) / args.q;
      for (int u = u_begin, i = 0; u < u_end; ++u, ++i) {
        const int buf = i % kWinBufs;
        if (i >= kWinBufs) mbar_wait_bounded(w_empty + 8 * buf, (i / kWinBufs - 1) & 1);
        const int kx = u / args.n_groups, mf0 = (u % args.n_groups) * args.taps_per_group;
        const int span = (min(args.taps_per_group, args.kf - mf0) - 1) * args.s;
        const unsigned char* src0 = xg + static_cast<size_t>(mf0) * args.s * row_bytes + kx * 128;
        const uint32_t dst0 = w_base + buf * win_bytes;
        int w = 0;  // the segment's first window row
        for (int b = b_first; b <= b_last; ++b) {
          const int t_lo = b == b_first ? m0 - b * args.q : 0;
          const int t_hi = b == b_last ? m_end - 1 - b * args.q : args.q - 1;
          const int n_rows = t_hi - t_lo + 1 + span;
          const unsigned char* src = src0 + (static_cast<size_t>(b) * args.qp + t_lo) * row_bytes;
          // chunks 8w .. of the window are this segment's; this thread takes
          // those equal to lt modulo kWinLoaders
          for (int e = (lt - 8 * w % kWinLoaders + kWinLoaders) % kWinLoaders; e < 8 * n_rows;
               e += kWinLoaders)
            cp_async_16(dst0 + (w + e / 8) * kWinPitch + (e % 8) * 16,
                        src + (e / 8) * row_bytes + (e % 8) * 16, 16);
          w += n_rows;
        }
        cp_async_arrive(w_full + 8 * buf);
      }
    } else if (warp == 1 && lane == 0) {
      const unsigned char* wk = reinterpret_cast<const unsigned char*>(args.wk);
      int t = 0, st = 0, phase = 0;  // taps issued; their stage and its round's parity
      for (int u = u_begin; u < u_end; ++u) {
        const int kx = u / args.n_groups, mf0 = (u % args.n_groups) * args.taps_per_group;
        const int taps = min(args.taps_per_group, args.kf - mf0);
        for (int j = 0; j < taps; ++j, ++t) {
          if (t >= b_stages) mbar_wait_bounded(b_empty + 8 * st, phase ^ 1);
          mbar_arrive_expect_tx(b_full + 8 * st, kBTile);
          const size_t row0 =
              ((static_cast<size_t>(mf0 + j) * args.g + gi) * kc_blocks + kx) * args.n + n0;
          bulk_copy(b_base + st * kBTile, wk + row0 * kRowBytes, kBTile, b_full + 8 * st);
          if (++st == b_stages) st = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: warpgroup c computes rows m0 + 64*MT*c ... + 64*MT - 1,
  // MT tiles of 64, by wgmma with A from registers (ldmatrix of the window)
  // and B by descriptor.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
  const int tid = threadIdx.x, lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int row0 = (tid / 128) * 64 * MT + (tid / 32 % 4) * 16;  // this warp's first row, tile 0
  // the window row this lane's ldmatrix address points at: row l % 8 of
  // matrix l / 8, matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  int seg[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = m0 + row0 + 64 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
    seg[mt] = r < m_total ? r / args.q - m0 / args.q : -1;
  }
  const uint32_t lane_col = (lane >> 4) * 16;
  float acc[MT][kAcc];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[mt][e] = 0.f;
  uint32_t a0[MT][4][4], a1[MT][4][4];  // A of the tap in flight and of the next one

  // The block's taps in one sequence, two at a time, so that the A of the
  // tap in flight (a0 or a1) and the one being loaded are named statically.
  int total = 0;  // taps of this block's units
  for (int u = u_begin; u < u_end; ++u)
    total += min(args.taps_per_group, args.kf - (u % args.n_groups) * args.taps_per_group);
  int u = u_begin - 1, i = -1, j = 0, taps = 0, buf = 0, held_win = -1;
  uint32_t a_unit[MT];  // this unit's first tap's A rows in the window
  uint32_t a_tap[MT];
  auto next_a = [&]() {  // the next tap's A in the window, opening its unit first
    if (j == taps) {
      ++u, ++i, j = 0, buf = i % kWinBufs;
      mbar_wait_bounded(w_full + 8 * buf, (i / kWinBufs) & 1);
      taps = min(args.taps_per_group, args.kf - (u % args.n_groups) * args.taps_per_group);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {  // rows past B*q read row 0, unused
        const int r = row0 + 64 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int row = seg[mt] >= 0 ? r + seg[mt] * (taps - 1) * args.s : 0;
        a_unit[mt] = w_base + buf * win_bytes + row * kWinPitch + lane_col;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) a_tap[mt] = a_unit[mt] + j * args.s * kWinPitch;
    ++j;
  };
  int st = 0, phase = 0, done_st = -1;  // this tap's B stage and parity; the last tap's stage
  auto retire = [&]() {  // the last tap is done: free its B stage, and its window if last
    if (leader && done_st >= 0) mbar_arrive(b_empty + 8 * done_st);
    if (leader && held_win >= 0) mbar_arrive(w_empty + 8 * held_win);
    held_win = j == taps ? buf : -1;
    done_st = st;
    if (++st == b_stages) st = 0, phase ^= 1;
  };
  for (int t = 0; t < total; t += 2) {
    next_a();
    window_tap<MT>(acc, a0, a_tap, b_full + 8 * st, phase, b_base + st * kBTile);
    retire();
    if (t + 1 == total) break;
    next_a();
    window_tap<MT>(acc, a1, a_tap, b_full + 8 * st, phase, b_base + st * kBTile);
    retire();
  }
  wgmma_wait_all();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    fence_regs(acc[mt]);
    keep_regs(a0[mt]);
    keep_regs(a1[mt]);
  }

  // Accumulator of m64nN: acc[4j + v] is row ar + 8*(v >> 1), column 8j + 2*ac + (v & 1).
  const int ac = lane % 4;
  const size_t out0 = (static_cast<size_t>(split) * args.g + gi) * m_total * args.n;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ar = row0 + 64 * mt + lane / 4;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = n0 + 8 * jn + 2 * ac;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + ar + 8 * h;
        if (m >= m_total) continue;
        const size_t at = out0 + static_cast<size_t>(m) * args.n + col;
        const float lo = acc[mt][4 * jn + 2 * h], hi = acc[mt][4 * jn + 2 * h + 1];
        if (args.out_bf16)  // rounded once, to nearest even
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(args.out) + at) =
              __floats2bfloat162_rn(lo, hi);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(args.out) + at) = make_float2(lo, hi);
      }
    }
  }
}

template <int NWG, int BN>
cudaError_t launch_tc(const TapArgs& args, int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Tf32x3, NWG, BN>();
  cudaError_t err = cudaFuncSetAttribute(tap_dots_tc_kernel<Tf32x3, NWG, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int m_total = args.batch * args.q;
  const dim3 grid((m_total + NWG * 64 - 1) / (NWG * 64), args.n / BN, args.g * splits);
  tap_dots_tc_kernel<Tf32x3, NWG, BN><<<grid, NWG * 128, smem, stream>>>(args);
  return cudaGetLastError();
}

template <int NWG, int MT>
cudaError_t launch_window(const WinArgs& args, int splits, cudaStream_t stream) {
  if (args.b_stages == 0) return cudaErrorInvalidValue;  // the windows do not fit
  const int smem = args.b_stages * kWinBN * kRowBytes + kWinBufs * args.win_rows * kWinPitch +
                   kWinBarriers + 1024;
  cudaError_t err = cudaFuncSetAttribute(window_taps_bf16_kernel<NWG, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int m_total = args.batch * args.q, bm = NWG * MT * 64;
  const dim3 grid((m_total + bm - 1) / bm, args.n / kWinBN, args.g * splits);
  window_taps_bf16_kernel<NWG, MT><<<grid, (NWG + 1) * 128, smem, stream>>>(args);
  return cudaGetLastError();
}

template <class E>
cudaError_t pack_weights(const void* wf, void* wk, int kf, int g, int kc, int n, int flip_t,
                         cudaStream_t stream) {
  using T = typename E::T;
  if (kc % E::kBK != 0) return cudaErrorInvalidValue;
  pack_weights_kernel<E><<<dim3(n / 32, kc / E::kBK, kf * g), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(wf), static_cast<T*>(wk), kf, g, kc, n, flip_t);
  return cudaGetLastError();
}

bool bad_shape(int g, int batch, int qp, int kc, int n, int kf, int s, int q, int kbk, int bn) {
  return g <= 0 || batch <= 0 || q <= 0 || kf <= 0 || s <= 0 || kc % kbk != 0 || n % bn != 0 ||
         qp < q + (kf - 1) * s || g > 65535;
}

// y = the f32 partial sums' fixed-order sum over the splits, as OutT.
template <typename OutT>
cudaError_t sum_splits(const float* partial, void* y, int splits, size_t count,
                       cudaStream_t stream) {
  const size_t n4 = count / 4;
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
  sum_splits_kernel<OutT><<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(partial),
                                                      static_cast<OutT*>(y), splits, n4);
  return cudaGetLastError();
}

cudaError_t tap_dots_f32(const void* xp, const void* wk, float* partial, float* y, int g,
                         int batch, int qp, int kc, int n, int kf, int s, int q, int nwg, int bn,
                         int splits, cudaStream_t stream) {
  const int n_kb = kf * (kc / Tf32x3::kBK);
  if (bad_shape(g, batch, qp, kc, n, kf, s, q, Tf32x3::kBK, bn) || splits < 1 || splits > n_kb ||
      g * splits > 65535 || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int kb_per_split = (n_kb + splits - 1) / splits;
  if ((splits - 1) * kb_per_split >= n_kb) return cudaErrorInvalidValue;  // an empty split
  TapArgs args{xp, wk, splits > 1 ? partial : y, g, batch, qp, kc, n, kf, s, q, kb_per_split,
               n_kb};
  cudaError_t err;
  if (nwg == 2 && bn == 128) err = launch_tc<2, 128>(args, splits, stream);
  else if (nwg == 1 && bn == 64) err = launch_tc<1, 64>(args, splits, stream);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits<float>(partial, y, splits, static_cast<size_t>(g) * batch * q * n, stream);
}

cudaError_t window_taps_bf16(const void* xp, const void* wk, float* partial, void* y, int g,
                             int batch, int qp, int kc, int n, int kf, int s, int q, int tiles,
                             int taps_per_group, int splits, cudaStream_t stream) {
  if (bad_shape(g, batch, qp, kc, n, kf, s, q, 64, kWinBN) || taps_per_group < 1 ||
      taps_per_group > kf)
    return cudaErrorInvalidValue;
  const int n_groups = (kf + taps_per_group - 1) / taps_per_group;
  const int n_units = kc / 64 * n_groups;
  if (splits < 1 || splits > n_units || g * splits > 65535 || (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int units_per_split = (n_units + splits - 1) / splits;
  if ((splits - 1) * units_per_split >= n_units) return cudaErrorInvalidValue;  // an empty split
  const int win_rows = window_rows_needed(batch * q, q, tiles * 64, (taps_per_group - 1) * s);
  WinArgs args{static_cast<const __nv_bfloat16*>(xp),
               static_cast<const __nv_bfloat16*>(wk),
               splits > 1 ? static_cast<void*>(partial) : y,
               g, batch, qp, kc, n, kf, s, q, taps_per_group, n_groups, units_per_split, n_units,
               win_rows, window_b_stages(win_rows), splits == 1};
  cudaError_t err;
  if (tiles == 4) err = launch_window<2, 2>(args, splits, stream);
  else if (tiles == 2) err = launch_window<2, 1>(args, splits, stream);
  else if (tiles == 1) err = launch_window<1, 1>(args, splits, stream);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits<__nv_bfloat16>(partial, y, splits, static_cast<size_t>(g) * batch * q * n,
                                   stream);
}

}  // namespace

// C interface, loaded with ctypes. Each returns a cudaError_t (0 = launched).
//
// wf [kf, g, kc, n] (forward) or [kf, g, n, kc] (flip_t) -> wk
// [parts, kf, g, kc/kBK, n, kBK] (f32: parts 2, kBK 32; bf16: parts 1,
// kBK 64); kc % kBK == 0, n % 32 == 0 (bf16: n % 64 == 0). `bf16` selects
// the element type of wf and wk: 0 float32, 1 bfloat16.
extern "C" int gouter_pack_weights(const void* wf, void* wk, int kf, int g, int kc, int n,
                                   int flip_t, int bf16, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (kf <= 0 || g <= 0 || n % 32 != 0 || kc <= 0 || n <= 0 || kf * g > 65535)
    return cudaErrorInvalidValue;
  if (!bf16) return pack_weights<Tf32x3>(wf, wk, kf, g, kc, n, flip_t, stream);
  if (kc % 64 != 0 || n % 64 != 0) return cudaErrorInvalidValue;
  pack_weights_kernel_bf16<<<dim3(n / 64, kc / 64, kf * g), 256, 0, stream>>>(
      static_cast<const uint4*>(wf), static_cast<uint4*>(wk), kf, g, kc, n, flip_t);
  return cudaGetLastError();
}

// f32: y [g, batch, q, n] from xp [g, batch, qp, kc] and wk (above), all
// float32, contiguous and 16-byte aligned on `device`, qp >= q + (kf - 1) * s.
// Tile (nwg, bn) is (2, 128) or (1, 64); with splits > 1 the K blocks are
// split over `splits` block rows into the f32 partial [splits, g, batch*q,
// n] and summed.
extern "C" int gouter_tap_dots(const void* xp, const void* wk, float* partial, float* y, int g,
                               int batch, int qp, int kc, int n, int kf, int s, int q, int nwg,
                               int bn, int splits, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return tap_dots_f32(xp, wk, partial, y, g, batch, qp, kc, n, kf, s, q, nwg, bn, splits, stream);
}

// bf16: the same y from bfloat16 xp and wk, f32 sums, y rounded to bf16
// once; n % 128 == 0. Tiles of 64*tiles rows by 128 columns, tiles in {1,
// 2, 4} (4: two warpgroups of two 64-row tiles each).
// K runs over units (64 values of X, a group of taps_per_group taps); with
// splits > 1 the units are split over `splits` block rows into the f32
// partial and summed. The window of a tile must fit the shared memory.
extern "C" int gouter_window_taps_bf16(const void* xp, const void* wk, float* partial, void* y,
                                       int g, int batch, int qp, int kc, int n, int kf, int s,
                                       int q, int tiles, int taps_per_group, int splits,
                                       int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return window_taps_bf16(xp, wk, partial, y, g, batch, qp, kc, n, kf, s, q, tiles,
                          taps_per_group, splits, stream);
}
