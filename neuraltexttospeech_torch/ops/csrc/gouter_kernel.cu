// Tap-window grouped GEMM for Hopper (sm_90a): the MSD's folded grouped conv
// on the tensor cores, in two element forms: f32-accurate by 3xTF32, and
// bf16 with f32 accumulation.
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
// What bounds it on the card: operations. At the v1 MSD shapes a call does
// 2*g*B*q*kf*X*Y FLOP against (xp + wf + y) bytes, 70-500 FLOP per byte in
// f32 and twice that in bf16.
// - f32 (Tf32x3): the GAN tolerances rule out one-pass TF32 or bf16, and f32
//   FMAs on the CUDA cores stop at 67 TFLOP/s. So each f32 operand is split
//   into hi = tf32(a) and lo = tf32(a - hi) (round to nearest, ties away),
//   and lo*hi + hi*lo + hi*hi (small terms first) runs on the TF32 tensor
//   cores (495 TFLOP/s dense, so about 165 TFLOP/s of f32-accurate work),
//   about 2^-22 relative per product. The tensor cores' accumulator does not
//   round to nearest, so each K block of 32 sums into a fresh wgmma
//   accumulator that is then added to an f32 register accumulator.
// - bf16 (Bf16): one wgmma .bf16 product per K step (989 TFLOP/s dense); a
//   bf16 product is exact in f32. The whole K sums in the one wgmma
//   accumulator: its truncating adds lose at most 2^-23 of the running sum
//   each, one add per 16 products, so at the largest K (21 taps x 512 = 672
//   adds) under 2^-13 of the largest partial sum, a small fraction of the
//   2^-9 that the once-rounded bf16 output is allowed. A fresh accumulator
//   per block would buy nothing here and cost 64 registers.
//
// Design (both forms share the ring and the tiles):
// - A prologue kernel writes the weights K-major, [parts, kf, g, K/kBK, n,
//   kBK] (kBK = 32 f32 split into hi and lo, or 64 bf16 in one part), each
//   128-byte row already in the 128-byte swizzle that wgmma reads, so a B
//   tile is one contiguous block that a bulk async copy (the TMA unit) moves
//   into shared memory.
// - The main kernel: one block per (tile of the B*q rows, tile of N,
//   group[, K split]); one or two consumer warpgroups of 64 rows each. It
//   walks K as (tap mf, 128-byte chunk of X). A ring of 4 shared-memory
//   stages, each filled by 16-byte cp.async gathers of the window rows
//   (rows cross batch boundaries at any q; rows past B*q read zeros) and the
//   bulk copies of the B tiles, completes on an mbarrier per stage; a second
//   mbarrier per stage frees it after the warpgroups' wgmmas are done. Loads
//   run two blocks ahead.
// - f32: A goes from shared memory (rows padded against bank conflicts) to
//   registers, is split there, and feeds wgmma.mma_async m64nNk8 .tf32 from
//   registers. bf16: the gathers write A in the same 128-byte swizzle as B,
//   and both operands feed wgmma.mma_async m64nNk16 .bf16 by descriptor.
// - The wrapper picks the tile per call (128x128, else 64x64) so that each
//   call launches at least one block per SM; where 64x64 tiles cannot, K is
//   split over the blocks and a second kernel adds the f32 partial sums in a
//   fixed order (deterministic, no atomics), rounding to bf16 after the sum.

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
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kBK = 64;
  static constexpr int kParts = 1;
  static constexpr int kARowBytes = 128;  // swizzled, read by descriptor
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

// d[32] (+)= A[64x16] * B[16x64], both bf16, K-major and 128 B swizzled in
// shared memory at desc_a and desc_b; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t desc_a,
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64] (+)= A[64x16] * B[16x128], both bf16, K-major and 128 B swizzled in
// shared memory at desc_a and desc_b; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (BN == 128) wgmma_m64n128k8(d, a, desc, scale_d);
  else wgmma_m64n64k8(d, a, desc, scale_d);
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 128) wgmma_m64n128k16_bf16(d, desc_a, desc_b, scale_d);
  else wgmma_m64n64k16_bf16(d, desc_a, desc_b, scale_d);
}

// Byte offset of 16-byte chunk c of A row r in a shared-memory stage.
template <class E>
__device__ __forceinline__ uint32_t a_chunk_offset(int r, int c) {
  if constexpr (std::is_same_v<E, Bf16>) return r * kRowBytes + ((c ^ (r & 7)) << 4);
  else return r * E::kARowBytes + (c << 4);
}

struct TapArgs {
  const void* xp;  // [g, batch, qp, kc] of E::T
  const void* wk;  // [parts, kf, g, kc/kBK, n, kBK] of E::T, rows swizzled (the prologue's output)
  void* out;       // [splits, g, batch*q, n] f32 partial sums, or y [g, batch*q, n]
  int g, batch, qp, kc, n, kf, s, q, kb_per_split, n_kb;
  int out_bf16;    // out is bf16 (else f32)
};

template <class E, int NWG, int BN>
constexpr int smem_bytes() {
  return kStages * (E::kParts * BN * kRowBytes + NWG * 64 * E::kARowBytes) + 2 * kStages * 8 +
         1024;
}

template <class E, int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128) tap_dots_tc_kernel(const TapArgs args) {
  using T = typename E::T;
  constexpr bool kBf16 = std::is_same_v<E, Bf16>;
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

    if constexpr (kBf16) {
      // the gathers wrote A through the generic proxy; wgmma reads it
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint32_t a_wg = a_base + st * kAStage + (tid / 128) * 64 * kRowBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 16 bf16 = 32 bytes per K step
        wgmma_bf16<BN>(acc, b128_desc(a_wg + kk * 32), b128_desc(b_st + kk * 32), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty_bar + 8 * st);
    } else {
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
      if (kBf16 && args.out_bf16)  // rounded once, to nearest even
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(args.out) + at) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(args.out) + at) =
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
// at chunk c ^ (n % 8): f32 split into TF32 hi and lo (two parts), bf16 as
// it is (one part). One block per kBK x 32 tile.
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
      if constexpr (std::is_same_v<E, Bf16>) {
        wk[at * kBK + col] = __float2bfloat16_rn(v);  // exact: v came from bf16
      } else {
        const uint32_t hi = tf32_rna(v);
        const uint32_t lo = tf32_rna(v - __uint_as_float(hi));
        const size_t part = static_cast<size_t>(kf) * g * kc_blocks * n * kBK;
        wk[at * kBK + col] = __uint_as_float(hi);
        wk[part + at * kBK + col] = __uint_as_float(lo);
      }
    }
  }
}

template <class E, int NWG, int BN>
cudaError_t launch_tc(const TapArgs& args, int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<E, NWG, BN>();
  cudaError_t err = cudaFuncSetAttribute(tap_dots_tc_kernel<E, NWG, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int m_total = args.batch * args.q;
  const dim3 grid((m_total + NWG * 64 - 1) / (NWG * 64), args.n / BN, args.g * splits);
  tap_dots_tc_kernel<E, NWG, BN><<<grid, NWG * 128, smem, stream>>>(args);
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

template <class E>
cudaError_t tap_dots(const void* xp, const void* wk, float* partial, void* y, int g, int batch,
                     int qp, int kc, int n, int kf, int s, int q, int nwg, int bn, int splits,
                     cudaStream_t stream) {
  const int n_kb = kf * (kc / E::kBK);
  if (g <= 0 || batch <= 0 || q <= 0 || kf <= 0 || s <= 0 || kc % E::kBK != 0 || n % bn != 0 ||
      qp < q + (kf - 1) * s || splits < 1 || splits > n_kb || g * splits > 65535 ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int kb_per_split = (n_kb + splits - 1) / splits;
  if ((splits - 1) * kb_per_split >= n_kb) return cudaErrorInvalidValue;  // an empty split
  constexpr int kOutBf16 = std::is_same_v<E, Bf16>;
  TapArgs args{xp, wk, splits > 1 ? static_cast<void*>(partial) : y, g, batch, qp, kc, n, kf, s,
               q, kb_per_split, n_kb, splits > 1 ? 0 : kOutBf16};
  cudaError_t err;
  if (nwg == 2 && bn == 128) err = launch_tc<E, 2, 128>(args, splits, stream);
  else if (nwg == 1 && bn == 64) err = launch_tc<E, 1, 64>(args, splits, stream);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = static_cast<size_t>(g) * batch * q * n / 4;
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
  const float4* p = reinterpret_cast<const float4*>(partial);
  if constexpr (kOutBf16)
    sum_splits_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        p, static_cast<__nv_bfloat16*>(y), splits, n4);
  else
    sum_splits_kernel<float><<<blocks, 256, 0, stream>>>(p, static_cast<float*>(y), splits, n4);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each returns a cudaError_t (0 = launched).
// `bf16` selects the element type of wf, wk, xp and y: 0 float32, 1 bfloat16.
//
// wf [kf, g, kc, n] (forward) or [kf, g, n, kc] (flip_t) -> wk
// [parts, kf, g, kc/kBK, n, kBK] (f32: parts 2, kBK 32; bf16: parts 1,
// kBK 64); kc % kBK == 0, n % 32 == 0.
extern "C" int gouter_pack_weights(const void* wf, void* wk, int kf, int g, int kc, int n,
                                   int flip_t, int bf16, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (kf <= 0 || g <= 0 || n % 32 != 0 || kc <= 0 || n <= 0 || kf * g > 65535)
    return cudaErrorInvalidValue;
  return bf16 ? pack_weights<Bf16>(wf, wk, kf, g, kc, n, flip_t, stream)
              : pack_weights<Tf32x3>(wf, wk, kf, g, kc, n, flip_t, stream);
}

// y [g, batch, q, n] from xp [g, batch, qp, kc] and wk (above), contiguous
// and 16-byte aligned on `device`, qp >= q + (kf - 1) * s. Tile (nwg, bn) is
// (2, 128) or (1, 64); with splits > 1 the K blocks are split over `splits`
// block rows into the f32 partial [splits, g, batch*q, n] and summed.
extern "C" int gouter_tap_dots(const void* xp, const void* wk, float* partial, void* y, int g,
                               int batch, int qp, int kc, int n, int kf, int s, int q, int nwg,
                               int bn, int splits, int bf16, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return bf16 ? tap_dots<Bf16>(xp, wk, partial, y, g, batch, qp, kc, n, kf, s, q, nwg, bn,
                               splits, stream)
              : tap_dots<Tf32x3>(xp, wk, partial, y, g, batch, qp, kc, n, kf, s, q, nwg, bn,
                                 splits, stream);
}
