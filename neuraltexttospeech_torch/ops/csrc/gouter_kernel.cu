// Tap-window grouped GEMM for Hopper (sm_90a): the MSD's folded grouped conv.
//
// Replaces neuraltexttospeech_tpu/ops/gouter_kernel.py::gouter_tap_dots_pallas
// (pallas_call at :114, body :105-112). For xp [g, B, Qp, X] and
// wf [kf, g, X, Y] it computes
//
//   y[g, b, t, :] = sum_{mf < kf} xp[g, b, mf*s + t, :] @ wf[mf, g, :, :]
//
// for t < q, with f32 accumulation: per group g, a GEMM of M = B*q rows by
// N = Y columns over K = kf*X, whose A operand row (b, t) for tap mf is the
// shifted window row xp[g, b, mf*s + t]. No tap operand is materialised; the
// window is addressed in place, as the TPU kernel did in VMEM. The backward's
// dx is the same function on zero-padded dy with flipped, transposed weights
// (nn/fastconv.py), so one kernel serves both.
//
// What bounds it on the card: operations. At the v1 MSD shapes a call does
// 2*g*B*q*kf*X*Y FLOP against (xp + wf + y) bytes, some 70-500 FLOP per byte,
// above the f32 balance of the H100 (67 TFLOP/s over 3.35 TB/s, about 20).
// The HiFi-GAN loss budgets are f32 (TF32 off), so every product is an f32
// FMA here; tensor cores (3xTF32 or bf16 wgmma, TMA) are later work.
//
// Design, an SGEMM whose A tile is a gathered window: a 3-D grid, one block
// per (64-row tile of the B*q rows, 64-column tile of Y, group). The row
// index folds the batch in, so the short-q layers (q = 16 at the third
// scale) still fill 64-row tiles, as the TPU kernel's batch blocking did.
// The block walks K as (tap mf, 16-wide chunk of X): each step stages a
// [64 rows x 16] window tile (stored k-major) and a [16 x 64] weight tile in
// shared memory, double-buffered, with the next step's global loads held in
// registers while the current tile is multiplied. Each of the 256 threads
// keeps a 4x4 accumulator tile in registers. Rows past B*q read zeros and are
// not written; X and Y are multiples of 16 and 64 (the wrapper checks), so
// no other masks are needed.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;     // rows (b, t) per block
constexpr int kTileN = 64;     // output columns per block
constexpr int kTileK = 16;     // contraction step (a chunk of X at one tap)
constexpr int kThreads = 256;  // 16 x 16 threads, a 4x4 tile each
constexpr int kPad = 4;        // row padding of the k-major window tile

__global__ void __launch_bounds__(kThreads)
tap_dots_kernel(const float* __restrict__ xp, const float* __restrict__ wf,
                float* __restrict__ y, int n_groups, int batch, int qp, int x_dim,
                int y_dim, int kf, int s, int q) {
  __shared__ __align__(16) float as[2][kTileK][kTileM + kPad];
  __shared__ __align__(16) float bs[2][kTileK][kTileN];

  const int tid = threadIdx.x;
  const int tm = tid / 16;  // rows tm*4 .. tm*4+3 of the tile
  const int tn = tid % 16;  // columns tn*4 .. tn*4+3
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int m_total = batch * q;

  // This thread's window load: row ar of the tile, taps' columns kq..kq+3.
  const int ar = tid / 4, kq = (tid % 4) * 4;
  const bool a_ok = m0 + ar < m_total;
  const float* a_row = xp;
  if (a_ok) {
    const int b = (m0 + ar) / q, t = (m0 + ar) % q;
    a_row = xp + (static_cast<size_t>(g) * batch + b) * qp * x_dim +
            static_cast<size_t>(t) * x_dim + kq;
  }
  // Its weight load: row bk of the [16 x 64] tile, columns bn..bn+3.
  const int bk = tid / 16, bn = (tid % 16) * 4;
  const float* b_col =
      wf + (static_cast<size_t>(g) * x_dim + bk) * y_dim + n0 + bn;
  const size_t w_tap = static_cast<size_t>(n_groups) * x_dim * y_dim;

  const int x_steps = x_dim / kTileK;
  const int n_steps = kf * x_steps;
  float4 av, bv;
  auto fetch = [&](int step) {
    const int mf = step / x_steps, x0 = (step % x_steps) * kTileK;
    av = a_ok ? __ldg(reinterpret_cast<const float4*>(
                    a_row + static_cast<size_t>(mf) * s * x_dim + x0))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    bv = __ldg(reinterpret_cast<const float4*>(
        b_col + mf * w_tap + static_cast<size_t>(x0) * y_dim));
  };
  auto stage = [&](int buf) {
    as[buf][kq + 0][ar] = av.x;
    as[buf][kq + 1][ar] = av.y;
    as[buf][kq + 2][ar] = av.z;
    as[buf][kq + 3][ar] = av.w;
    *reinterpret_cast<float4*>(&bs[buf][bk][bn]) = bv;
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) fetch(step + 1);
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[buf][k][tm * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&bs[buf][k][tn * 4]);
      const float a4[4] = {a.x, a.y, a.z, a.w};
      const float w4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], w4[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (step + 1 < n_steps) stage(buf ^ 1);
    __syncthreads();
  }

  // Row (b, t) of group g is row g*B*q + b*q + t of y [g, B, q, Y].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= m_total) continue;
    float* dst = y + (static_cast<size_t>(g) * m_total + m) * y_dim + n0 + tn * 4;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// C interface, loaded with ctypes. Returns a cudaError_t (0 = launched).
// xp [g, batch, qp, x_dim], wf [kf, g, x_dim, y_dim] and y [g, batch, q, y_dim]
// are contiguous, 16-byte aligned f32 on `device`; x_dim % 16 == 0,
// y_dim % 64 == 0 and qp >= q + (kf - 1) * s.
extern "C" int gouter_tap_dots(const float* xp, const float* wf, float* y,
                               int n_groups, int batch, int qp, int x_dim,
                               int y_dim, int kf, int s, int q, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_groups <= 0 || batch <= 0 || q <= 0 || kf <= 0 || s <= 0 ||
      x_dim % kTileK != 0 || y_dim % kTileN != 0 || qp < q + (kf - 1) * s ||
      n_groups > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((batch * q + kTileM - 1) / kTileM, y_dim / kTileN, n_groups);
  tap_dots_kernel<<<grid, kThreads, 0, stream>>>(xp, wf, y, n_groups, batch, qp,
                                                 x_dim, y_dim, kf, s, q);
  return cudaGetLastError();
}
