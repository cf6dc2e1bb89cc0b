// Framed GEMM kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of syllable_detector_tpu/kernels/
// framed_gemm.py (framed_gemm, launched through pl.pallas_call; the
// polyphase resampler pallas_polyphase_resample runs on it). It computes
//
//   out[k, c] = sum_i x[gap + k*hop + i] * G[i, c],   i < window, c < m
//
// for k < n_frames, with samples past the end of x read as zero: the
// product of the hop-strided frame matrix of x with a constant [window, m]
// matrix G, without ever writing the frames to device memory. For the
// resampler, G holds every phase's filter taps at their own offsets (see
// ops/resample.polyphase_plan), so one product resamples a whole channel.
//
// What bounds it on the card: the bytes. The resampler's G is banded (column
// r has `taps` consecutive non-zero rows, ending at a row that grows with
// r; 12 % non-zero at 48k -> 44.1k), so the work that counts is 2 * nnz(G)
// operations per frame, a few microseconds of the card's fp32 rate, against
// the samples read and the output written once. A dense product does 3-8 x
// the multiply-adds, and with one load per multiply-add the load units, not
// the FMA units, set its pace.
//
// What the design does about it.
//   * Columns go in tiles of `cw` = 4 * cg neighbouring columns (32 for a
//     wide product). For each tile the wrapper finds, once per G, the row
//     range [lo, lo + rows) outside which the tile's columns are all zero,
//     and the sum runs over that range only: ~57 of 181 rows at 48k ->
//     44.1k. A dense G gives [0, window) and nothing is skipped.
//   * The wrapper also lays the tiles' bands out for the kernel, once per
//     G: band[tile][row - lo][cg_i * 4 + j] = G[row, tile*cw + j*cg + cg_i],
//     zero past the range, the window and m. A thread owns columns
//     cg_i + j*cg (j < 4): it reads them as one 16-byte load, the warp's
//     loads of a row are one 128-byte line that stays in L1 (the bands of
//     all tiles are 37 KB at 48k), and the warp's stores of a row of the
//     result are contiguous.
//   * A thread keeps a kF frames x 4 columns register tile (kF = 8): per
//     row of G 1 load of G and 8 of samples feed 32 FMAs; where hop and lo
//     are multiples of 4 the samples are read as float4 along k (4 rows: 12
//     16-byte loads for 128 FMAs). A warp is 32 / cg threads across frames
//     (frame fg + r * 32/cg, so neighbouring threads read neighbouring hops)
//     by cg across columns: one unit of kF * 32/cg frames x cw columns.
//     Where one unit's span would not fit in shared memory (a long hop: 2560
//     at 192k -> 11.025k), a thread takes kF = 4 frames, half the span, at
//     half the FMAs per load of G. The warps of a CTA take
//     the units of its `frames` frames in turn. CTAs are small (one unit of
//     frames, 4 warps at the resampler's shapes), so that several share an
//     SM and one's staging hides behind another's sums. Where a launch has
//     few units (a narrow dense G over few frames) `ksplit` warps share a
//     unit, each summing a part of the rows, and the parts are added in
//     shared memory in the order of the rows.
//   * A CTA stages the contiguous span of its frames once for all column
//     tiles, (frames - 1) * hop + window samples, zero past n. While
//     staging it notes whether the span holds a NaN or an Inf. If it does,
//     the CTA computes its frames from all of G's rows instead: 0 * NaN is
//     NaN, so the dense product has NaN in every column of such a frame,
//     and the result keeps that.
// Sums are fp32 FMAs over k in ascending order (with a row split: per part,
// then over the parts), no TF32, as Precision.HIGHEST asks of the JAX
// kernel; a skipped row would have added an exact zero, so without a row
// split the result does not depend on the tiling. The TPU
// kernel's slab parts exist for its layout and are not carried over.

#include <cuda_runtime.h>

#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxDevices = 64;
constexpr int kWideFrames = 8;  // kF of every shape whose span fits
constexpr int kNarrowFrames = 4;
constexpr int kColsPerThread = 4;
constexpr long long kSmemLimit = 232448;  // bytes one block may opt in to
constexpr long long kSmemDefault = 48 * 1024;

struct Shape {
  int window;
  int m;
  int hop;
  int gap;
  int cg;          // threads of a warp across columns: 1, 2, 4 or 8
  int n_tiles;     // column tiles of 4 * cg columns
  int frames;      // frames per CTA, a multiple of fpt * 32 / cg
  int fpt;         // frames a thread takes: kWideFrames or kNarrowFrames
  int ksplit;      // warps that share a unit, each summing a part of the rows
  int band_rows;   // rows of each tile's band in `band`
  int span;        // floats staged per CTA (a multiple of 4)
};

__device__ __forceinline__ bool non_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// kSplit: `ksplit` warps share a unit (else s.ksplit is 1 and the code for it
// is compiled out: the registers it costs lose the resampler a CTA per SM).
// kF: frames a thread takes (s.fpt).
template <bool kVec, bool kSplit, int kF>
__global__ void __launch_bounds__(kMaxWarps * 32)
    framed_gemm_kernel(const float* __restrict__ x, long long n,
                       const float* __restrict__ g,       // [window, m]
                       const float* __restrict__ band,    // [tiles, band_rows, 4*cg]
                       const int* __restrict__ ranges,    // [tiles, 2]: lo, rows
                       long long n_frames, float* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) float xs[];
  const long long f0 = (long long)blockIdx.x * s.frames;
  const long long start = s.gap + f0 * s.hop;

  // the span of this CTA's frames; zero past the end of x
  bool bad = false;
  const float* src = x + start;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && start + s.span <= n) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(xs);
    for (int i = threadIdx.x; i < s.span / 4; i += blockDim.x) {
      const float4 v = __ldg(src4 + i);
      bad |= non_finite(v.x) | non_finite(v.y) | non_finite(v.z) | non_finite(v.w);
      dst4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < s.span; i += blockDim.x) {
      const float v = start + i < n ? __ldg(src + i) : 0.0f;
      bad |= non_finite(v);
      xs[i] = v;
    }
  }
  const bool dense = __syncthreads_or(bad);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int fgw = 32 / s.cg;                 // threads across frames
  const int fg = lane / s.cg;
  const int ci = lane - fg * s.cg;
  const int unit_frames = kF * fgw;
  const int frame_blocks = s.frames / unit_frames;
  const int cw = kColsPerThread * s.cg;

  // With ksplit > 1 a CTA has exactly one warp per (unit, part of the rows),
  // so that every warp reaches the barrier of the reduction below.
  const int ksplit = kSplit ? s.ksplit : 1;
  for (int w = warp; w < s.n_tiles * frame_blocks * ksplit; w += warps) {
    const int u = w / ksplit;
    const int part = w - u * ksplit;
    const int tile = u / frame_blocks;
    const int fb = u - tile * frame_blocks;
    const int fl = fb * unit_frames + fg;  // this thread's frames: fl + r*fgw
    const int c0 = tile * cw + ci;         // its columns: c0 + j*cg
    float acc[kF][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kF; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.0f;
    }
    if (dense) {
      // all rows of G, straight from the matrix
      int gcol[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) gcol[j] = min(c0 + j * s.cg, s.m - 1);
      const int chunk = (s.window + ksplit - 1) / ksplit;
      const int k_end = min(s.window, (part + 1) * chunk);
      for (int k = part * chunk; k < k_end; ++k) {
        float gv[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          gv[j] = __ldg(g + (long long)k * s.m + gcol[j]);
        }
#pragma unroll
        for (int r = 0; r < kF; ++r) {
          const float xv = xs[(fl + r * fgw) * s.hop + k];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            acc[r][j] = fmaf(xv, gv[j], acc[r][j]);
          }
        }
      }
    } else {
      const int lo = __ldg(ranges + 2 * tile);
      const int rows = __ldg(ranges + 2 * tile + 1);  // a multiple of 4
      const float4* bt = reinterpret_cast<const float4*>(
                             band + (long long)tile * s.band_rows * cw) + ci;
      const float* xb = xs + fl * s.hop + lo;
      const int xstep = fgw * s.hop;
      const int chunk = ((rows + ksplit - 1) / ksplit + 3) / 4 * 4;
      const int k_end = min(rows, (part + 1) * chunk);
      for (int k = part * chunk; k < k_end; k += 4) {
        float4 gv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gv[q] = __ldg(bt + (k + q) * s.cg);
#pragma unroll
        for (int r = 0; r < kF; ++r) {
          float xv[4];
          if (kVec) {
            const float4 v = *reinterpret_cast<const float4*>(xb + r * xstep + k);
            xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) xv[q] = xb[r * xstep + k + q];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][0] = fmaf(xv[q], gv[q].x, acc[r][0]);
            acc[r][1] = fmaf(xv[q], gv[q].y, acc[r][1]);
            acc[r][2] = fmaf(xv[q], gv[q].z, acc[r][2]);
            acc[r][3] = fmaf(xv[q], gv[q].w, acc[r][3]);
          }
        }
      }
    }
    if (kSplit) {
      // the parts' sums meet in shared memory and are added in the order of
      // the rows by the warp of part 0
      float* red = xs + s.span;  // [warps][8 frames x 4 columns][32 lanes]
      constexpr int kTile = kF * kColsPerThread;
      if (part > 0) {
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          red[(w * kTile + q) * 32 + lane] = acc[q / kColsPerThread][q % kColsPerThread];
        }
      }
      __syncthreads();
      if (part > 0) continue;
      for (int p = 1; p < ksplit; ++p) {
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          acc[q / kColsPerThread][q % kColsPerThread] += red[((w + p) * kTile + q) * 32 + lane];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kF; ++r) {
      const long long f = f0 + fl + r * fgw;
      if (f >= n_frames) continue;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = c0 + j * s.cg;
        if (c < s.m) out[f * s.m + c] = acc[r][j];
      }
    }
  }
}

// The span, and with a row split one register tile per thread.
size_t smem_bytes(const Shape& s, int threads) {
  const size_t red = s.ksplit > 1
      ? static_cast<size_t>(threads) * s.fpt * kColsPerThread : 0;
  return (static_cast<size_t>(s.span) + red) * sizeof(float);
}

// A span above 48 KB has to opt in; the opt-in is a maximum, raised once
// per kernel instantiation, device and size.
template <bool kVec, bool kSplit, int kF>
cudaError_t opt_in(int device, size_t smem) {
  static std::mutex mutex;
  static size_t granted[kMaxDevices] = {};
  if (static_cast<long long>(smem) <= kSmemDefault) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mutex);
  if (device >= 0 && device < kMaxDevices && smem <= granted[device]) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      framed_gemm_kernel<kVec, kSplit, kF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    granted[device] = smem;
  }
  return err;
}

template <bool kVec, bool kSplit, int kF>
int launch(const float* x, long long n, const float* g, const float* band,
           const int* ranges, long long n_frames, float* out, const Shape& s,
           int threads, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(s, threads);
  const cudaError_t err = opt_in<kVec, kSplit, kF>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long gx = (n_frames + s.frames - 1) / s.frames;
  framed_gemm_kernel<kVec, kSplit, kF><<<static_cast<unsigned>(gx), threads, smem, stream>>>(
      x, n, g, band, ranges, n_frames, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* sd_framed_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream` (device `device`): x [n] float32, g
// [window, m] float32 row-major, out [n_frames, m] float32, all device
// pointers. Frame k reads x[gap + k*hop + i], i < window. The tiling is the
// wrapper's: `cg` threads of a warp across columns (1, 2, 4 or 8; a column
// tile is 4 * cg columns), `ksplit` warps per unit (each sums a part of the
// rows; above 1 the CTA must have exactly one warp per part of each unit),
// `fpt` frames a thread (8, or 4 where a unit's span of 8 would not fit),
// `frames` frames per CTA (a multiple of fpt * 32 / cg), `threads` per CTA
// (whole warps, at most 256); `band`
// [tiles, band_rows, 4 * cg] and `ranges` [tiles, 2] (first row, row count;
// counts are multiples of 4 and first rows too when `vec` is set) are the
// tiles' bands of g as the note at the head of this file lays them out,
// device pointers. `vec` reads samples as float4 along k and needs hop % 4
// == 0. Returns cudaErrorInvalidValue for a geometry it cannot launch
// (among them a span that does not fit in shared memory), else
// cudaGetLastError() after the launch: 0 when the launch was taken.
int sd_framed_gemm(const float* x, long long n, const float* g, int window,
                   int m, int hop, int gap, long long n_frames, float* out,
                   const float* band, const int* ranges, int band_rows, int cg,
                   int ksplit, int fpt, int frames, int threads, int vec,
                   int device, void* stream) {
  if (window < 1 || m < 1 || hop < 1 || gap < 0 || n < 0 || n_frames < 1 ||
      (cg != 1 && cg != 2 && cg != 4 && cg != 8) || band_rows < 0 ||
      band_rows % 4 != 0 || threads < 32 || threads > kMaxWarps * 32 ||
      threads % 32 != 0 || frames < 1 || ksplit < 1 ||
      (fpt != kWideFrames && fpt != kNarrowFrames) || frames % (fpt * 32 / cg) != 0 ||
      (vec && hop % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s;
  s.window = window;
  s.m = m;
  s.hop = hop;
  s.gap = gap;
  s.cg = cg;
  s.n_tiles = (m + kColsPerThread * cg - 1) / (kColsPerThread * cg);
  s.frames = frames;
  s.fpt = fpt;
  s.ksplit = ksplit;
  s.band_rows = band_rows;
  // a row split needs one warp for each part of each unit
  if (ksplit > 1 &&
      s.n_tiles * (frames / (fpt * 32 / cg)) * ksplit != threads / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the last frame's rows run to lo + rows <= window + 6 (both rounded to 4)
  const long long span = ((long long)(frames - 1) * hop + window + 8 + 3) / 4 * 4;
  s.span = static_cast<int>(span);
  if (static_cast<long long>(smem_bytes(s, threads)) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((n_frames + frames - 1) / frames > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SD_LAUNCH(V, S, F) \
  launch<V, S, F>(x, n, g, band, ranges, n_frames, out, s, threads, device, st)
#define SD_LAUNCH_VS(F)                                                             \
  (ksplit > 1 ? (vec ? SD_LAUNCH(true, true, F) : SD_LAUNCH(false, true, F))       \
              : (vec ? SD_LAUNCH(true, false, F) : SD_LAUNCH(false, false, F)))
  return fpt == kWideFrames ? SD_LAUNCH_VS(kWideFrames) : SD_LAUNCH_VS(kNarrowFrames);
#undef SD_LAUNCH_VS
#undef SD_LAUNCH
}

}  // extern "C"
