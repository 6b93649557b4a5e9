// Fused frames -> log-mel kernel for Hopper (sm_90a): one pass, FFT based.
//
// Replaces neuraltexttospeech_tpu/ops/mel_kernel.py::fused_frames_to_mel
// (Pallas body _mel_kernel, pallas_call at :163). For windowed frames
// F [N, n_fft] it computes
//
//   out = log(max(|rfft(F)|^p @ M, 1e-5))        [N, n_mels]
//
// The TPU kernel formed the rDFT as two dense products with cos/sin
// matrices, because the MXU has no FFT; that is about 2*n_fft*(n_fft/2+1)*2
// FLOP a frame. Here the rDFT is a real FFT, about 2.5*n_fft*log2(n_fft)
// FLOP a frame, and the mel projection runs over the basis's nonzeros only.
//
// What bounds it on the card: bytes. The frames (4*n_fft bytes a frame) are
// read once and only [N, n_mels] is written; the FLOPs are a few per byte,
// far below the H100's f32 balance (67 TFLOP/s over 3.35 TB/s, about 20).
// So the design keeps everything between the load and the store on chip,
// in one launch with no scratch buffer and no atomics:
//
// - A block takes kPoints / (n_fft/2) frames (4 at n_fft = 1024, so the
//   GAN step's 512 frames give 128 blocks) and loads them coalesced, 16 B
//   a thread, into shared memory. A real frame x of length n_fft, read as
//   complex, is z[k] = x[2k] + i*x[2k+1], k < H = n_fft/2: the load needs
//   no reordering.
// - Z = FFT_H(z) by log2(H) radix-2 Stockham stages that ping-pong between
//   two shared buffers (natural order in and out, no bit reversal).
// - The split step gives the n_fft/2 + 1 bins of the real FFT:
//   X[k] = (Z[k] + conj(Z[H-k]))/2 - i*W^k*(Z[k] - conj(Z[H-k]))/2, with
//   W = exp(-2*pi*i/n_fft); then |X|^p from |X|^2 (p/2 == 1: no root,
//   p/2 == 0.5: sqrt, else powf).
// - Each mel is a short dot product over one contiguous range of bins
//   (the basis in CSR form, built on the host from the dense filterbank),
//   then log(max(., 1e-5)) and the store.
//
// Twiddles come from a table W^k, k <= n_fft/2, built on the host in float64
// and cast to f32 (W_H^j = W^(2j)), so no sincos runs on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 2048;  // complex points a block holds (frames * H)

template <int LOG2_NFFT>
__global__ void __launch_bounds__(kThreads)
logmel_fft_kernel(const float* __restrict__ frames, const float2* __restrict__ twiddle,
                  const int* __restrict__ mel_lo, const int* __restrict__ mel_ptr,
                  const float* __restrict__ mel_w, float* __restrict__ out,
                  int n_frames, int n_mels, int power_mode, float half_p) {
  constexpr int kN = 1 << LOG2_NFFT;  // n_fft
  constexpr int kH = kN / 2;          // complex FFT length
  constexpr int kLogH = LOG2_NFFT - 1;
  constexpr int kFrames = kPoints / kH;
  constexpr int kBins = kH + 1;
  static_assert(kFrames * (kBins) <= 2 * kPoints, "power spectrum must fit");

  __shared__ __align__(16) float2 buf[2][kPoints];
  __shared__ float2 tw[kBins];  // W^k, k = 0..H

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - f0);

  for (int k = tid; k < kBins; k += kThreads) tw[k] = __ldg(twiddle + k);
  {  // the block's frames, 16 B a thread; frames past the end read zeros
    const float4* src = reinterpret_cast<const float4*>(frames + static_cast<size_t>(f0) * kN);
    float4* dst = reinterpret_cast<float4*>(buf[0]);
    const int valid = nf * (kN / 4);
    for (int q = tid; q < kPoints / 2; q += kThreads)
      dst[q] = q < valid ? __ldg(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // Stockham radix-2: stage l reads x[i], x[i + H/2] and writes
  // y[2i - q] = a + b, y[2i - q + s] = (a - b) * W_H^(i - q), s = 2^l, q = i mod s.
  int src = 0;
#pragma unroll
  for (int l = 0; l < kLogH; ++l) {
    const int s = 1 << l;
    const float2* x = buf[src];
    float2* y = buf[src ^ 1];
    for (int idx = tid; idx < kPoints / 2; idx += kThreads) {
      const int f = idx / (kH / 2), i = idx % (kH / 2);
      const float2* xf = x + f * kH;
      float2* yf = y + f * kH;
      const float2 a = xf[i], b = xf[i + kH / 2];
      const int q = i & (s - 1);
      const float2 w = tw[2 * (i - q)];  // W_H^(i-q) = W^(2(i-q))
      const float dr = a.x - b.x, di = a.y - b.y;
      yf[2 * i - q] = make_float2(a.x + b.x, a.y + b.y);
      yf[2 * i - q + s] = make_float2(dr * w.x - di * w.y, dr * w.y + di * w.x);
    }
    src ^= 1;
    __syncthreads();
  }

  // Split step and |X|^p into the other buffer, [frames][H + 1] floats.
  const float2* z = buf[src];
  float* pw = reinterpret_cast<float*>(buf[src ^ 1]);
  for (int idx = tid; idx < kFrames * kBins; idx += kThreads) {
    const int f = idx / kBins, k = idx % kBins;
    const float2 zk = z[f * kH + (k & (kH - 1))];
    const float2 zc = z[f * kH + ((kH - k) & (kH - 1))];
    // E = (Z[k] + conj Z[H-k]) / 2, O = (Z[k] - conj Z[H-k]) / (2i)
    const float er = 0.5f * (zk.x + zc.x), ei = 0.5f * (zk.y - zc.y);
    const float orr = 0.5f * (zk.y + zc.y), oi = -0.5f * (zk.x - zc.x);
    const float2 w = tw[k];
    const float xr = er + (orr * w.x - oi * w.y);
    const float xi = ei + (orr * w.y + oi * w.x);
    const float m2 = fmaf(xr, xr, xi * xi);
    float p;
    if (power_mode == 1) p = m2;
    else if (power_mode == 2) p = sqrtf(m2);
    else p = powf(m2, half_p);
    pw[idx] = p;
  }
  __syncthreads();

  // Mel projection over each mel's bin range, log, store.
  for (int idx = tid; idx < nf * n_mels; idx += kThreads) {
    const int f = idx / n_mels, m = idx % n_mels;
    const float* p = pw + f * kBins + __ldg(mel_lo + m);
    const int w0 = __ldg(mel_ptr + m), w1 = __ldg(mel_ptr + m + 1);
    float acc = 0.f;
    for (int j = w0; j < w1; ++j) acc = fmaf(p[j - w0], __ldg(mel_w + j), acc);
    out[static_cast<size_t>(f0 + f) * n_mels + m] = logf(fmaxf(acc, 1e-5f));
  }
}

template <int LOG2_NFFT>
cudaError_t launch(const float* frames, const float2* twiddle, const int* mel_lo,
                   const int* mel_ptr, const float* mel_w, float* out, int n_frames,
                   int n_mels, int power_mode, float half_p, cudaStream_t stream) {
  constexpr int kFrames = kPoints / (1 << (LOG2_NFFT - 1));
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  logmel_fft_kernel<LOG2_NFFT><<<blocks, kThreads, 0, stream>>>(
      frames, twiddle, mel_lo, mel_ptr, mel_w, out, n_frames, n_mels, power_mode, half_p);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Returns a cudaError_t (0 = launched).
// frames [n_frames, n_fft] (16-byte aligned), twiddle [n_fft/2 + 1] complex,
// mel_lo [n_mels], mel_ptr [n_mels + 1], mel_w [mel_ptr[n_mels]] and
// out [n_frames, n_mels] are contiguous on `device`; n_fft is 64, 256 or 1024.
// Mel m is sum_j mel_w[mel_ptr[m] + j] * |X[mel_lo[m] + j]|^p.
// power_mode: 1 = |X|^2, 2 = |X|, 0 = (|X|^2)^half_p.
extern "C" int logmel_frames(const float* frames, const float* twiddle, const int* mel_lo,
                             const int* mel_ptr, const float* mel_w, float* out,
                             int n_frames, int n_fft, int n_mels, int power_mode,
                             float half_p, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_frames <= 0 || n_mels <= 0) return cudaErrorInvalidValue;
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  switch (n_fft) {
    case 64:
      return launch<6>(frames, tw, mel_lo, mel_ptr, mel_w, out, n_frames, n_mels,
                       power_mode, half_p, stream);
    case 256:
      return launch<8>(frames, tw, mel_lo, mel_ptr, mel_w, out, n_frames, n_mels,
                       power_mode, half_p, stream);
    case 1024:
      return launch<10>(frames, tw, mel_lo, mel_ptr, mel_w, out, n_frames, n_mels,
                        power_mode, half_p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
