// Monotonic alignment search (MAS, width 1) for Hopper (sm_90a).
//
// Replaces neuraltexttospeech_tpu/ops/mas.py::maximum_path (:94), which is
// two lax.scans and no Pallas kernel: a Viterbi forward over mel rows and a
// backtrack. For each utterance b with text length P = in_lens[b] and mel
// length M = out_lens[b], over log_attn [T_mel, T_text]:
//
//   la[i, j]   = log_attn[i, j] if j < P else -1e9
//   log_p[0,j] = la[0, 0] if j == 0 else -1e9
//   shifted    = log_p[i-1, j-1] (-1e9 at j == 0)
//   choose[i,j]= shifted >= log_p[i-1, j]
//   log_p[i,j] = max(la[i, j] + max(shifted, log_p[i-1, j]), -1e9)
//
// then walks back from j = P - 1 at row min(M, T_mel) - 1, writes a 1 at
// (i, j) and steps j -= choose[i, j] (never below 0). Rows at or past M
// stay zero. The arithmetic is the plain loop's f32 add, max and clamp, with
// nothing to contract into an FMA, so the result equals the twin
// (ops/mas_kernel.py::maximum_path_reference) bit for bit.
//
// What bounds it on the card: not bytes (log_attn read once, choose and the
// path written once: about 14 MB at 16 x 768 x 128, some 4 us at 3.35 TB/s)
// but the chain of T_mel dependent rows, each a max over two neighbours. A
// plain PyTorch loop pays several launches per row; here one launch does it
// all:
//
// - One block per utterance, thread j owns text position j (T_text rounded
//   up to a warp, at most 1024). Its running log_p stays in a register; the
//   previous row lives in shared memory, double-buffered, so each row costs
//   one __syncthreads. The next row of log_attn is loaded one row ahead.
// - The forward stops at row min(M, T_mel) - 1: later rows are never read.
// - choose goes to a uint8 [B, T_mel, T_text] scratch in device memory; one
//   thread then walks the rows back and writes the one-hot path into an
//   output the wrapper zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;

__global__ void __launch_bounds__(1024)
mas_kernel(const float* __restrict__ log_attn, const int* __restrict__ in_lens,
           const int* __restrict__ out_lens, uint8_t* __restrict__ choose,
           float* __restrict__ path, int t_mel, int t_text) {
  extern __shared__ float prev_rows[];  // [2][blockDim.x]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int width = blockDim.x;
  const int in_len = in_lens[b];
  const int rows = min(out_lens[b], t_mel);
  if (rows <= 0) return;  // the whole block: nothing to align
  const size_t plane = static_cast<size_t>(t_mel) * t_text;
  const float* la = log_attn + b * plane;
  uint8_t* ch = choose + b * plane;
  const bool live = j < t_text;
  const bool key = live && j < in_len;

  float cur = (j == 0 && key) ? la[0] : kNeg;  // row 0: only j == 0 reachable
  float next = (key && rows > 1) ? la[t_text + j] : kNeg;
  prev_rows[j] = cur;
  __syncthreads();
  for (int i = 1; i < rows; ++i) {
    const float row = next;
    if (key && i + 1 < rows) next = la[static_cast<size_t>(i + 1) * t_text + j];
    const float* prev = prev_rows + ((i - 1) & 1) * width;
    const float shifted = j == 0 ? kNeg : prev[j - 1];
    if (live) ch[static_cast<size_t>(i) * t_text + j] = shifted >= cur;
    cur = fmaxf(row + fmaxf(shifted, cur), kNeg);
    prev_rows[(i & 1) * width + j] = cur;
    __syncthreads();  // also publishes this row's choose to thread 0
  }

  if (j != 0) return;
  float* out = path + b * plane;
  int jj = in_len - 1;
  for (int i = rows - 1; i >= 0; --i) {
    const bool inside = jj >= 0 && jj < t_text;
    if (inside) out[static_cast<size_t>(i) * t_text + jj] = 1.0f;
    if (i > 0 && inside) jj = max(jj - ch[static_cast<size_t>(i) * t_text + jj], 0);
  }
}

}  // namespace

// log_attn [batch, t_mel, t_text] f32, in_lens/out_lens [batch] int32,
// choose [batch, t_mel, t_text] uint8 scratch, path [batch, t_mel, t_text]
// f32 zero-filled by the caller. Returns the launch's CUDA error code.
extern "C" int mas_maximum_path(const float* log_attn, const int* in_lens, const int* out_lens,
                                uint8_t* choose, float* path, int batch, int t_mel, int t_text,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || t_mel <= 0 || t_text <= 0 || t_text > 1024) return cudaErrorInvalidValue;
  const int threads = (t_text + 31) / 32 * 32;
  mas_kernel<<<batch, threads, 2 * threads * sizeof(float), stream>>>(
      log_attn, in_lens, out_lens, choose, path, t_mel, t_text);
  return cudaGetLastError();
}
