// Fused wav-frames -> log-mel kernel for Hopper (sm_90a).
//
// Replaces neuraltexttospeech_tpu/ops/mel_kernel.py::fused_frames_to_mel
// (Pallas body _mel_kernel, pallas_call at :163). For windowed frames
// F [N, n_fft] it computes
//
//   re = F @ Dr,  im = F @ Di                  (the rDFT as two products with
//                                               constant cos/sin matrices)
//   out = log(max((re^2 + im^2)^(p/2) @ M, 1e-5))
//
// What bounds this formulation on the card: operations. A frame costs
// 2*n_fft*n_bins*2 + 2*n_bins*n_mels FLOP against 4*n_fft bytes read, about
// 1000 FLOP per byte at n_fft = 1024, far above the card's f32 balance
// (67 TFLOP/s over 3.35 TB/s, about 20). The function itself needs far less:
// an rFFT is about 2.5*n_fft*log2(n_fft) FLOP a frame and the mel basis is
// sparse, so the least time for it is set by the bytes of the frames. The
// DFT-as-matmul form is the TPU kernel's (the MXU has no FFT), kept here as
// the first, simple port. The 1e-3 log-mel budget rules out TF32 and bf16
// tensor cores, so every product is an f32 FMA.
//
// Design: a 2-D grid. Block (x, y) takes a tile of 32 frames and the y-th
// chunk of 64 bins. re and im of [32 frames x 64 bins] accumulate in
// registers (a 4x4 tile per thread) while frame and Dr/Di tiles stream
// through shared memory 16 taps at a time. The chunk's |X|^p goes to shared
// memory and is projected at once onto the mels, so no [frames, bins]
// spectrum ever reaches device memory: each block writes only its
// [32 x n_mels] partial mel sums. Splitting the bins over blocks keeps the
// card full when a call has few frames (one 10 s wav is ~860 frames, 27
// frame tiles for 132 SMs). A second small kernel adds the partial sums in
// a fixed order (deterministic, no atomics) and takes the log.
// The host pads Dr/Di to a multiple of 64 bins and M to a multiple of 16
// mels with zeros, so the inner loops carry no masks.

#include <cuda_runtime.h>

namespace {

constexpr int kTileF = 32;    // frames per block
constexpr int kTileB = 64;    // bins per block (one chunk)
constexpr int kTileK = 16;    // DFT taps per shared-memory stage
constexpr int kThreads = 128; // 8 frame groups x 16 bin (or mel) groups
constexpr int kPad = 4;       // row padding of the frame-indexed tiles

// partial[y, f, m] = sum over the bins of chunk y of |X[f, b]|^p * M[b, m].
template <int MPT>  // mels per thread; n_mels_p = 16 * MPT
__global__ void __launch_bounds__(kThreads)
mel_partial_kernel(const float* __restrict__ frames, const float* __restrict__ dr,
                   const float* __restrict__ di, const float* __restrict__ melw,
                   float* __restrict__ partial, int n_frames, int n_fft,
                   int n_bins_p, int n_mels, int power_mode, float half_p) {
  __shared__ __align__(16) float fs[kTileK][kTileF + kPad];  // frames, tap-major
  __shared__ __align__(16) float rs[kTileK][kTileB];         // Dr tile
  __shared__ __align__(16) float is[kTileK][kTileB];         // Di tile
  __shared__ __align__(16) float ps[kTileB][kTileF + kPad];  // |X|^p, bin-major

  const int tid = threadIdx.x;
  const int fg = tid / 16;  // frames fg*4 .. fg*4+3 of the tile
  const int bg = tid % 16;  // bins bg*4 .. bg*4+3 of the chunk; mels bg*MPT ..
  const int f0 = blockIdx.x * kTileF;
  const int b0 = blockIdx.y * kTileB;
  const int n_mels_p = 16 * MPT;

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < n_fft; k0 += kTileK) {
    {  // 32 frames x 16 taps: one float4 per thread, stored tap-major
      const int f = tid / 4, kq = (tid % 4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f0 + f < n_frames)
        v = *reinterpret_cast<const float4*>(
            frames + static_cast<size_t>(f0 + f) * n_fft + k0 + kq);
      fs[kq + 0][f] = v.x;
      fs[kq + 1][f] = v.y;
      fs[kq + 2][f] = v.z;
      fs[kq + 3][f] = v.w;
    }
    for (int q = tid; q < kTileK * kTileB / 4; q += kThreads) {
      const int k = q / (kTileB / 4), bq = (q % (kTileB / 4)) * 4;
      const size_t off = static_cast<size_t>(k0 + k) * n_bins_p + b0 + bq;
      *reinterpret_cast<float4*>(&rs[k][bq]) =
          __ldg(reinterpret_cast<const float4*>(dr + off));
      *reinterpret_cast<float4*>(&is[k][bq]) =
          __ldg(reinterpret_cast<const float4*>(di + off));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&fs[k][fg * 4]);
      const float4 r = *reinterpret_cast<const float4*>(&rs[k][bg * 4]);
      const float4 s = *reinterpret_cast<const float4*>(&is[k][bg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float rv[4] = {r.x, r.y, r.z, r.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(av[i], rv[j], re[i][j]);
          im[i][j] = fmaf(av[i], sv[j], im[i][j]);
        }
    }
    __syncthreads();
  }

  // |X|^p from |X|^2 (p/2 == 1: no root; p/2 == 0.5: sqrt; else powf).
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float m2 = fmaf(re[i][j], re[i][j], im[i][j] * im[i][j]);
      float pw;
      if (power_mode == 1) pw = m2;
      else if (power_mode == 2) pw = sqrtf(m2);
      else pw = powf(m2, half_p);
      ps[bg * 4 + j][fg * 4 + i] = pw;
    }
  __syncthreads();

  float acc[4][MPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int b = 0; b < kTileB; ++b) {
    const float4 a = *reinterpret_cast<const float4*>(&ps[b][fg * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float* w = melw + static_cast<size_t>(b0 + b) * n_mels_p + bg * MPT;
    float wv[MPT];
#pragma unroll
    for (int j = 0; j < MPT; ++j) wv[j] = __ldg(w + j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MPT; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  }

  float* dst = partial + static_cast<size_t>(blockIdx.y) * n_frames * n_mels;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + fg * 4 + i;
    if (f >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int m = bg * MPT + j;
      if (m < n_mels) dst[static_cast<size_t>(f) * n_mels + m] = acc[i][j];
    }
  }
}

// out[f, m] = log(max(sum_y partial[y, f, m], 1e-5)), summed in order of y.
__global__ void mel_log_kernel(const float* __restrict__ partial,
                               float* __restrict__ out, int n_chunks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int y = 0; y < n_chunks; ++y) s += partial[static_cast<size_t>(y) * n + idx];
  out[idx] = logf(fmaxf(s, 1e-5f));
}

template <int MPT>
cudaError_t launch(const float* frames, const float* dr, const float* di,
                   const float* melw, float* partial, float* out, int n_frames,
                   int n_fft, int n_bins_p, int n_mels, int power_mode,
                   float half_p, cudaStream_t stream) {
  const int n_chunks = n_bins_p / kTileB;
  const dim3 grid((n_frames + kTileF - 1) / kTileF, n_chunks);
  mel_partial_kernel<MPT><<<grid, kThreads, 0, stream>>>(
      frames, dr, di, melw, partial, n_frames, n_fft, n_bins_p, n_mels,
      power_mode, half_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = n_frames * n_mels;
  mel_log_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, n_chunks, n);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Returns a cudaError_t (0 = launched).
// frames [n_frames, n_fft], dr/di [n_fft, n_bins_p], melw [n_bins_p, n_mels_p],
// partial [n_bins_p / 64, n_frames, n_mels] (scratch) and out [n_frames, n_mels]
// are contiguous f32 on `device`; frames 16-byte aligned.
// power_mode: 1 = |X|^2, 2 = |X|, 0 = (|X|^2)^half_p.
extern "C" int logmel_frames(const float* frames, const float* dr,
                             const float* di, const float* melw, float* partial,
                             float* out, int n_frames, int n_fft, int n_bins_p,
                             int n_mels, int n_mels_p, int power_mode,
                             float half_p, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_frames <= 0 || n_fft % kTileK != 0 || n_bins_p % kTileB != 0 ||
      n_mels_p % 16 != 0 || n_mels > n_mels_p)
    return cudaErrorInvalidValue;
  switch (n_mels_p / 16) {
#define LOGMEL_CASE(M)                                                         \
  case M:                                                                      \
    return launch<M>(frames, dr, di, melw, partial, out, n_frames, n_fft,      \
                     n_bins_p, n_mels, power_mode, half_p, stream);
    LOGMEL_CASE(1)  // up to 16 mels (small test configs)
    LOGMEL_CASE(5)  // 65..80 mels (every model config)
#undef LOGMEL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
