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
// are zero. The arithmetic is the plain loop's f32 add, max and clamp, with
// nothing to contract into an FMA, so the result equals the twin
// (ops/mas_kernel.py::maximum_path_reference) bit for bit.
//
// What bounds it on the card: not bytes (log_attn's rows read once and the
// path written once: about 12.6 MB at 16 x 768 x 128, some 4 us at 3.35
// TB/s) but the chain of min(M, T_mel) dependent rows, each a max over two
// neighbours that live in different threads. One block per utterance, so
// 16 SMs at the training shapes; its warps:
//
// - Warp 0 runs the chain alone, with no block barrier. Lane l owns the J
//   consecutive text positions lJ .. lJ + J - 1 (J = ceil(T_text / 32),
//   rounded up to an instantiated J) and keeps their log_p in registers.
//   Only its first position's left neighbour lives in another lane: one
//   __shfl_up_sync a row brings it, issued a row ahead, and that position
//   is computed last, so the shuffle's latency hides behind the lane's other
//   positions. Each lane keeps its own choices of a slot of 8 rows in
//   registers (bit r*J + p) and stores them once a slot; a slot runs as
//   straight-line code with its positions loaded ahead. What is left is
//   the one warp's issue: some 7 instructions a position and row, issued at
//   about one per 4 cycles (the clock64 stamps read 105 cycles a row at J =
//   4, 135-138 at J = 5 and 6). A first design (positions 32p + l, a
//   shuffle, a ballot and a store per p, a division a row, generic stores)
//   took 190-320; a second chain warp over half the positions, fed by the
//   first through shared memory, ran no faster a row.
// - Warp 1 streams log_attn rows into a shared-memory ring of slots of 8
//   rows, as many slots as fit 96 KB (24 at T_text 128: 192 rows ahead),
//   one bulk copy (TMA) a slot where T_text % 4 == 0; elsewhere warps 1-3
//   copy 4-byte elements by cp.async. Each slot completes on an mbarrier;
//   the chain waits once per 8 rows and finds its rows already there.
// - Warps 4-7 write zeros over the whole [T_mel, T_text] plane with 16-byte
//   stores while the chain runs; then warps 5-7, on the schedulers the chain
//   does not use, follow the chain's progress and rewrite each row's
//   choices in position order (bit k of word w is position 32w + k).
// - After the chain, warp 0 backtracks 32 rows at a time: lane k takes row
//   top - k's choices at the 32 positions a 32-row walk can reach from two
//   words, and every lane steps through the rows on shuffled words with j
//   as a one-hot mask; lane k keeps row top - k's j for the index array,
//   from which every thread writes its rows' ones.
// - The choices and the index array stay in shared memory, 27 KB at 768 x
//   128, beside the ring; where they do not fit (at T_text 1024 past ~500
//   frames) they go to a global scratch of the same layout: a second
//   instantiation of the kernel. No zero fill or scratch beside the launch
//   otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // warp 0 the chain, 1-3 the loads, 4-7 the zeros
constexpr int kLoaders = 3;
constexpr int kGroup = 8;           // rows per ring slot
constexpr int kMaxSlots = 32;       // the ring holds 3 to 32 slots,
constexpr int kRingBudget = 98304;  // as many as fit 96 KB
constexpr int kMaxSmem = 232448;
constexpr int kStamps = 5;  // kernel start, forward done, backtrack done, zeros done, end
constexpr int kBarrierBytes = 2 * kMaxSlots * 8 + 16;  // the slots' mbarriers, the chain's progress

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Traps (a launch error) instead of spinning for ever if the phase has not
// completed after about 2^32 cycles, seconds: a fault surfaces as an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

// Contiguous bulk copy global -> shared by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct MasArgs {
  const float* log_attn;  // [batch, t_mel, t_text]
  const int* in_lens;     // [batch]
  const int* out_lens;    // [batch]
  float* path;            // [batch, t_mel, t_text], written whole
  uint32_t* scratch;      // [batch, bits_words(J, t_mel)] bits and index array, or null: shared
  long long* stamps;      // [batch, kStamps, 2] clock64 and globaltimer, or null
  int t_mel, t_text;
  int pitch, slots;  // ring rows of pitch floats (t_text rounded up to 4), slots of kGroup rows
};

// Shared memory of one block: the ring (slots of kGroup rows of `pitch`
// floats, then 32*J floats of padding: a lane reads up to 32*J positions of
// the last row), 2*kMaxSlots mbarriers and, where they fit, the choice bits
// (t_mel rows of J words, twice: as ballotted and in position order) and
// the index array (t_mel words).
struct MasPlan {
  int pitch, slots;
  bool bits_in_shared;
  size_t smem_bytes;
};

__host__ __device__ size_t ring_bytes(int j, int pitch, int slots) {
  return static_cast<size_t>(slots) * kGroup * pitch * 4 + 32 * j * 4;
}

// 32-bit words of one utterance's choice bits, both layouts, and index array.
__host__ __device__ size_t bits_words(int j, int t_mel) {
  return static_cast<size_t>((t_mel + kGroup - 1) / kGroup) * 32 * ((kGroup * j + 31) / 32) +
         static_cast<size_t>(t_mel) * (j + 1);
}

MasPlan mas_plan(int j, int t_mel, int t_text) {
  MasPlan p;
  p.pitch = (t_text + 3) / 4 * 4;
  p.slots = kRingBudget / (kGroup * p.pitch * 4);
  p.slots = p.slots < 3 ? 3 : (p.slots > kMaxSlots ? kMaxSlots : p.slots);
  const size_t base = ring_bytes(j, p.pitch, p.slots) + kBarrierBytes;
  const size_t bits = bits_words(j, t_mel) * 4;
  p.bits_in_shared = base + bits <= static_cast<size_t>(kMaxSmem);
  p.smem_bytes = base + (p.bits_in_shared ? bits : 0);
  return p;
}


// la[p] = row[p], p < J: 16- or 8-byte shared loads where J allows (row is
// J-aligned: the ring's pitch is a multiple of 4 floats).
template <int J>
__device__ __forceinline__ void load_positions(float (&la)[J], const float* row) {
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int p = 0; p < J; p += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + p);
      la[p] = x.x, la[p + 1] = x.y, la[p + 2] = x.z, la[p + 3] = x.w;
    }
  } else if constexpr (J % 2 == 0) {
#pragma unroll
    for (int p = 0; p < J; p += 2) {
      const float2 x = *reinterpret_cast<const float2*>(row + p);
      la[p] = x.x, la[p + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int p = 0; p < J; ++p) la[p] = row[p];
  }
}

// kGlobalBits: the choice bits and index array live in the global scratch
// (a separate instantiation, so that the shared-memory path compiles to
// shared loads and stores, not generic ones).
template <int J, bool kGlobalBits>
__global__ void __launch_bounds__(kThreads, 1) mas_kernel(const MasArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = a.pitch, slots = a.slots;
  float* ring = reinterpret_cast<float*>(smem);
  const size_t ring_size = ring_bytes(J, pitch, slots);
  const uint32_t full = smem_u32(smem + ring_size);  // kMaxSlots x 8 bytes
  const uint32_t empty = full + 8 * kMaxSlots;
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t_mel = a.t_mel, t_text = a.t_text;
  const int in_len = a.in_lens[b];
  const int rows = max(0, min(a.out_lens[b], t_mel));
  const size_t plane = static_cast<size_t>(t_mel) * t_text;
  const bool bulk = t_text % 4 == 0;  // rows of 16-byte multiples: one bulk copy a slot
  // per slot of 8 rows, each lane's choice words (bit r*J + p: row r,
  // position lane*J + p); then per row J words in position order (bit k of
  // word w is position 32w + k); then the index array
  volatile int* progress = reinterpret_cast<int*>(smem + ring_size + 16 * kMaxSlots);
  constexpr int kWords = (kGroup * J + 31) / 32;  // a lane's choice words a slot
  uint32_t* bits = kGlobalBits ? a.scratch + static_cast<size_t>(b) * bits_words(J, t_mel)
                               : reinterpret_cast<uint32_t*>(smem + ring_size + kBarrierBytes);
  uint32_t* plain = bits + static_cast<size_t>((t_mel + kGroup - 1) / kGroup) * 32 * kWords;
  int* idx = reinterpret_cast<int*>(plain + static_cast<size_t>(t_mel) * J);
  long long* stamp = a.stamps ? a.stamps + static_cast<size_t>(b) * kStamps * 2 : nullptr;
  auto mark = [&](int k) {
    if (stamp) {
      stamp[2 * k] = clock64();
      stamp[2 * k + 1] = global_ns();
    }
  };

  if (threadIdx.x == 0) {
    mark(0);
    *progress = 1;  // rows whose choices are stored: row 0 has none
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, bulk ? 1 : kLoaders * 32);  // the bulk copy, or every cp.async
      mbar_init(empty + 8 * s, 1);                         // the chain
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // The forward: row i's log_p in v, its choices a slot at a time. No
    // mask for positions at or past P: they feed only positions to their
    // right, and the backtrack reads no choice there.
    const bool first_lane = lane == 0;
    float v[J];  // positions lane*J .. lane*J + J - 1
    if (rows > 0) {
      mbar_wait(full, 0);
      const float first = ring[0];
#pragma unroll
      for (int p = 0; p < J; ++p) v[p] = (p == 0 && first_lane && in_len > 0) ? first : kNeg;
    }
    // Each lane keeps its own choices of a slot's 8 rows in kWords words
    // (bit r*J + p: row r of the slot, position lane*J + p) and stores them
    // once a slot: no ballot or store a row.
    // The shuffle that brings a row's left neighbour is issued one row ahead,
    // as soon as the lane's last position is known, and position 0, the one
    // that needs it, is computed last: the shuffle's latency hides behind
    // the lane's other positions.
    float up = __shfl_up_sync(kFull, v[J - 1], 1);  // for row 1
    auto compute = [&](const float (&la)[J], int r, uint32_t (&chosen)[kWords]) {
      const float first_left = first_lane ? kNeg : up;  // the last position of lane - 1
      const float v0 = v[0];
#pragma unroll
      for (int p = J - 1; p >= 1; --p) {  // from the right: v[p - 1] is still the last row's
        const float left = v[p - 1];
        chosen[(r * J + p) / 32] |= static_cast<uint32_t>(left >= v[p]) << ((r * J + p) % 32);
        v[p] = fmaxf(la[p] + fmaxf(left, v[p]), kNeg);
      }
      if constexpr (J > 1) up = __shfl_up_sync(kFull, v[J - 1], 1);  // for the next row
      chosen[r * J / 32] |= static_cast<uint32_t>(first_left >= v0) << (r * J % 32);
      v[0] = fmaxf(la[0] + fmaxf(first_left, v0), kNeg);
      if constexpr (J == 1) up = __shfl_up_sync(kFull, v[0], 1);
    };
    // A whole slot of 8 rows runs as straight-line code, its positions
    // loaded kAhead rows at a time before they are used.
    constexpr int kAhead = J <= 8 ? 8 : (J <= 16 ? 4 : 2);
    const int groups = (rows + kGroup - 1) / kGroup;
    int slot = 0, phase = 0;
    for (int g = 0; g < groups; ++g) {
      if (g > 0) mbar_wait(full + 8 * slot, phase);
      const float* base = ring + static_cast<size_t>(slot) * kGroup * pitch + lane * J;
      const int r_begin = g == 0 ? 1 : 0, r_end = min(kGroup, rows - g * kGroup);
      uint32_t chosen[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) chosen[q] = 0;
      if (r_begin == 0 && r_end == kGroup) {
#pragma unroll
        for (int r0 = 0; r0 < kGroup; r0 += kAhead) {
          float la[kAhead][J];
#pragma unroll
          for (int r = 0; r < kAhead; ++r) load_positions<J>(la[r], base + (r0 + r) * pitch);
#pragma unroll
          for (int r = 0; r < kAhead; ++r) compute(la[r], r0 + r, chosen);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          if (r < r_begin || r >= r_end) continue;
          float la[J];
          load_positions<J>(la, base + r * pitch);
          compute(la, r, chosen);
        }
      }
#pragma unroll
      for (int q = 0; q < kWords; ++q) bits[(static_cast<size_t>(g) * 32 + lane) * kWords + q] = chosen[q];
      __syncwarp();
      if (first_lane) {
        if (g + 1 < groups) mbar_arrive(empty + 8 * slot);  // the slot is read
        __threadfence_block();
        *progress = g * kGroup + r_end;  // the choices of rows below are stored
      }
      if (++slot == slots) slot = 0, phase ^= 1;
    }
    __syncwarp();
    if (lane == 0) mark(1);
  } else if (warp <= kLoaders) {
    const float* src0 = a.log_attn + b * plane;
    const int groups = (rows + kGroup - 1) / kGroup;
    const int lt = threadIdx.x - 32;
    if (!bulk || lt == 0) {
      for (int g = 0; g < groups; ++g) {
        const int slot = g % slots;
        if (g >= slots) mbar_wait(empty + 8 * slot, (g / slots - 1) & 1);
        const int r0 = g * kGroup, nr = min(kGroup, rows - r0);
        const float* src = src0 + static_cast<size_t>(r0) * t_text;
        float* dst = ring + static_cast<size_t>(slot) * kGroup * pitch;
        if (bulk) {  // the slot's rows lie one after another in log_attn and in the ring
          const uint32_t bytes = nr * t_text * 4;
          mbar_arrive_expect_tx(full + 8 * slot, bytes);
          bulk_copy(smem_u32(dst), src, bytes, full + 8 * slot);
        } else {
          for (int e = lt; e < nr * t_text; e += kLoaders * 32) {
            const int rr = e / t_text, c = e % t_text;
            cp_async_4(smem_u32(dst + rr * pitch + c), src + e);
          }
          cp_async_arrive(full + 8 * slot);
        }
      }
    }
  } else {
    // zeros over the plane: 16-byte stores between a scalar head and tail
    const int zt = threadIdx.x - 32 * (kLoaders + 1), nz = kThreads - 32 * (kLoaders + 1);
    float* out = a.path + b * plane;
    const size_t to16 = ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4;
    const size_t head = to16 < plane ? to16 : plane;
    const size_t body = (plane - head) / 4;
    for (size_t e = zt; e < head; e += nz) out[e] = 0.f;
    float4* out4 = reinterpret_cast<float4*>(out + head);
    for (size_t e = zt; e < body; e += nz) out4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (size_t e = head + 4 * body + zt; e < plane; e += nz) out[e] = 0.f;
    if (zt == 0) mark(3);
    // Then warps 5-7 (beside the chain, on the other schedulers) put the
    // choices in position order as the chain stores them, rows h, h + 3, ...
    // for warp 5 + h: bit k of word w of row i is position 32w + k, bit
    // x / J of ballot word x % J. They poll the chain's progress.
    const int h = warp - (kLoaders + 2);
    if (h >= 0) {
      int src_lane[J], src_pos[J];  // this lane's bit of word w: position 32w + lane
#pragma unroll
      for (int w = 0; w < J; ++w) src_lane[w] = (32 * w + lane) / J, src_pos[w] = (32 * w + lane) % J;
      int i = 1 + h;
      while (i < rows) {
        const int ready = __shfl_sync(kFull, lane == 0 ? *progress : 0, 0);  // one view a warp
        __threadfence_block();
        if (i >= ready) {
          __nanosleep(256);
          continue;
        }
        for (; i < ready; i += 3) {
          const uint32_t* slot_bits = bits + static_cast<size_t>(i / kGroup) * 32 * kWords;
          const int r = i % kGroup;
#pragma unroll
          for (int w = 0; w < J; ++w) {
            const int bit = r * J + src_pos[w];
            const uint32_t word = __ballot_sync(
                kFull, (slot_bits[src_lane[w] * kWords + bit / 32] >> (bit % 32)) & 1u);
            if (lane == w) plain[static_cast<size_t>(i) * J + w] = word;
          }
        }
      }
    }
  }
  __syncthreads();

  if (warp == 0) {
    // The backtrack, 32 rows at a time: j at row top - k lies in [lo, lo +
    // 31], lo = j_top - 31; lane k takes row top - k's choices there from
    // two position-order words, and every lane walks the 32 words with j as
    // a one-hot mask.
    int j = in_len - 1;
    const bool valid = j >= 0 && j < t_text;
    for (int top = rows - 1; top >= 0; top -= 32) {
      const int row = top - lane;
      int at = -1;
      if (valid) {
        const int wq = j >> 5, base = (wq - 1) * 32, lo = j - 31;
        uint32_t hi_w = 0, lo_w = 0;  // positions [base + 32, base + 64) and [base, base + 32)
        if (row >= 1) {               // row 0 takes no step
          hi_w = plain[static_cast<size_t>(row) * J + wq];
          if (wq > 0) lo_w = plain[static_cast<size_t>(row) * J + wq - 1];
        }
        if (wq == 0) hi_w &= ~1u;  // j never steps below 0
        else if (wq == 1) lo_w &= ~1u;
        const uint32_t word = static_cast<uint32_t>(
            ((static_cast<unsigned long long>(hi_w) << 32) | lo_w) >> (lo - base));
        uint32_t mask = 1u << 31, here = 0;  // bit k: position lo + k
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const uint32_t wk = __shfl_sync(kFull, word, k);
          if (lane == k) here = mask;
          mask = (wk & mask) ? mask >> 1 : mask;
        }
        at = lo + 31 - __clz(here);
        j = lo + 31 - __clz(mask);
      }
      if (row >= 0) idx[row] = at;
    }
    if (lane == 0) mark(2);
  }
  __syncthreads();
  float* out = a.path + b * plane;
  for (int i = threadIdx.x; i < rows; i += kThreads)
    if (idx[i] >= 0) out[static_cast<size_t>(i) * t_text + idx[i]] = 1.f;
  if (stamp) {
    __syncthreads();
    if (threadIdx.x == 0) mark(4);
  }
}

// The instantiated widths: J words of 32 text positions per row.
constexpr int kWidths[] = {1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32};

int words_for(int t_text) {
  for (int j : kWidths)
    if (32 * j >= t_text) return j;
  return 0;
}

template <int J, bool kGlobalBits>
cudaError_t launch_bits(const MasArgs& a, int batch, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mas_kernel<J, kGlobalBits>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mas_kernel<J, kGlobalBits><<<batch, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int J>
cudaError_t launch(MasArgs a, int batch, cudaStream_t stream) {
  const MasPlan p = mas_plan(J, a.t_mel, a.t_text);
  if (!p.bits_in_shared && a.scratch == nullptr) return cudaErrorInvalidValue;
  a.pitch = p.pitch;
  a.slots = p.slots;
  return p.bits_in_shared ? launch_bits<J, false>(a, batch, p.smem_bytes, stream)
                          : launch_bits<J, true>(a, batch, p.smem_bytes, stream);
}

}  // namespace

// 32-bit words of global scratch the kernel needs per utterance at this
// shape: 0 where the choice bits and index array fit in shared memory.
extern "C" long long mas_scratch_words(int t_mel, int t_text) {
  const int j = words_for(t_text);
  if (j == 0 || t_mel <= 0) return 0;
  return mas_plan(j, t_mel, t_text).bits_in_shared
             ? 0 : static_cast<long long>(bits_words(j, t_mel));
}

// log_attn [batch, t_mel, t_text] f32, in_lens/out_lens [batch] int32 ->
// path [batch, t_mel, t_text] f32, every element written. scratch: null, or
// batch * mas_scratch_words(t_mel, t_text) words where that is not 0.
// stamps: null, or [batch, 5, 2] int64 (clock64 and %globaltimer at the
// kernel's start, the forward's end, the backtrack's end, the zeros' end and
// the end). Returns the launch's CUDA error code.
extern "C" int mas_maximum_path(const float* log_attn, const int* in_lens, const int* out_lens,
                                float* path, uint32_t* scratch, long long* stamps, int batch,
                                int t_mel, int t_text, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int j = words_for(t_text);
  if (batch <= 0 || t_mel <= 0 || t_text <= 0 || j == 0) return cudaErrorInvalidValue;
  const MasArgs a{log_attn, in_lens, out_lens, path, scratch, stamps, t_mel, t_text, 0, 0};
  switch (j) {
    case 1: return launch<1>(a, batch, stream);
    case 2: return launch<2>(a, batch, stream);
    case 3: return launch<3>(a, batch, stream);
    case 4: return launch<4>(a, batch, stream);
    case 5: return launch<5>(a, batch, stream);
    case 6: return launch<6>(a, batch, stream);
    case 8: return launch<8>(a, batch, stream);
    case 12: return launch<12>(a, batch, stream);
    case 16: return launch<16>(a, batch, stream);
    case 24: return launch<24>(a, batch, stream);
    default: return launch<32>(a, batch, stream);
  }
}
