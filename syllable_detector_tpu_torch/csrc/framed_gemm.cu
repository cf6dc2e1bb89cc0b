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
// the FMA units, set its pace. On a short channel (a file of a few seconds)
// the bytes are a microsecond or less: there the launch has to reach the
// card's SMs at all, and the latency of the first loads is the cost.
//
// What the design does about it.
//   * The band launch and the long launch's run form (the slot form's
//     column quads below): columns go in tiles of `cw` = 4 * cg
//     neighbouring columns (32 for a wide product). For each tile the
//     wrapper finds, once per G, the row
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
//   * A thread keeps a kF frames x 4 columns register tile: per row of G 1
//     load of G and kF of samples feed 4 * kF FMAs; the samples are read as
//     float4 along k where their rows start on 16 bytes (4 rows: kF + 4
//     16-byte loads for 16 * kF FMAs). A warp is 32 / cg threads across
//     frames (frame fg + r * 32/cg, so neighbouring threads read
//     neighbouring hops) by cg across columns: one unit of kF * 32/cg frames
//     x cw columns. With `ksplit` above 1, ksplit warps share a unit, each
//     summing a part of the rows, and the parts are added in shared memory
//     in the order of the rows.
//   * Two launches, chosen by the wrapper from the frame count and the
//     card's SMs (tiling in kernels/framed_gemm.py):
//     - the long launch (a 60 s channel) cuts the grid by frames only, in
//       one of two forms.
//       The slot form, where a frame's window rounded up to an odd multiple
//       of 4 floats (`stride`) is at most a few hops and G's bands are deep
//       or its columns few (192k -> 11.025k: window 1254, hop 923). Each
//       frame is staged on its own, in a slot of `stride` floats, by
//       cp.async (16 bytes a lane where the frame starts on 16 bytes, else
//       a float a lane, realigned), so that every read of four rows of a
//       frame is one aligned float4 and 8 frames' reads fall on distinct
//       banks; the overlap of neighbouring frames is staged twice (1.06-2
//       x the samples in shared memory, none more from device memory). A
//       CTA walks frame blocks (blockIdx.x, + gridDim.x, ...) with two
//       buffers: the next block's copy is in flight while this one is
//       summed, and the grid is the CTAs the card holds at once. A lane
//       owns 4 adjacent columns (a quad) and kF frames; a warp is 8, 16 or
//       32 frame lanes by 4, 2 or 1 quads, and sums only over its quads'
//       bands (the rows of G holding a non-zero in the quad's columns,
//       widened to the deepest band of the warp's quads, 1.15-1.23 x the
//       non-zeros at the long hops against 2.6-3.1 x for the column
//       tiles'). The quads' bands are laid out side by side a row, so a
//       warp reads one 16 * cg-byte piece of G a row; G's next four rows
//       are loaded while four are summed. The warp's sums are shuffled so
//       that each store writes whole rows of its output tile.
//       The run form elsewhere (short hops, shallow bands over many
//       columns): a CTA stages the contiguous span of its frames once for
//       all column tiles, (frames - 1) * hop + window samples, and its
//       warps take the units of all tiles in turn; kF = 8, or 4 where one
//       unit's span would not fit. CTAs are small (one unit of frames, 4
//       warps at the resampler's shapes), so that several share an SM.
//     - the band launch (where the long one leaves SMs idle: a channel of a
//       few seconds; the wrapper's rule counts the long launch's CTAs
//       against the SMs and the depth of the bands): the grid is
//       frame blocks x groups of neighbouring column tiles, the fewest
//       groups that give two CTAs an SM (one tile a group on a short
//       channel); a CTA takes one unit of kF = 2 frames a thread of each of
//       its tiles, and where a group leaves warps to spare, up to 8 warps
//       split each unit's rows (parts of 16 rows or more), so that a CTA's
//       chain of loads and sums is short and there are CTAs for every SM
//       (over a single tile the launch only re-cuts the frames). A CTA
//       stages only its group's rows of G, from the first band's first row
//       to the last band's end, [lo, lo + rows) of each frame: frame by
//       frame at a row stride of `stride` floats (an odd multiple of 4, so
//       that the warp's float4 reads of several frames fall on distinct
//       banks) where the hop is longer than that, so the gaps between the
//       rows are not staged (<= 228 of 724 rows a frame at 48k -> 11.025k);
//       else, where the rows of neighbouring frames overlap, as one
//       contiguous run from row lo at stride hop. Every group's CTAs read
//       the channel from L2 (a 5 s channel is < 4 MB of the card's 50 MB);
//       the fewer the groups, the fewer times.
//   * The non-finite rule. A CTA notes whether the span of its frames
//     ((frames - 1) * hop + window + 8 samples from its first frame, zero
//     past n) holds a NaN or an Inf. If it does, the CTA computes its frames
//     from all of G's rows instead: 0 * NaN is NaN, so the dense product
//     has NaN in every column of such a frame, and the result keeps that.
//     The run form checks the span as it stages it; the slot form checks
//     each block's slots in shared memory (v * 0 is NaN only for a NaN or
//     an Inf), so a block whose slots hold one sums all rows. The band launch
//     reads the whole span too, in one pass: it checks every sample and
//     stores those of its band, so a sample outside the band still sends
//     the CTA to the dense sums (from device memory, a path for bad input
//     only).
// Sums are fp32 FMAs over k in ascending order, no TF32, as
// Precision.HIGHEST asks of the JAX kernel. A skipped row would have added
// an exact zero, so without a row split the result does not depend on the
// tiling: the band launch, the run form and the slot form give the same
// frames bit for bit (up to the sign of a zero) where they have ksplit 1. With a row split (ksplit > 1) each part sums
// its rows in ascending order and part 0 then adds parts 1, 2, ... to its
// own in that order, the same order on every run; that rounds differently
// from one unsplit sum. The TPU kernel's slab parts exist for its layout
// and are not carried over.

#include <cuda_runtime.h>

#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxSlotWarps = 16;  // the long launch's slot form
constexpr int kMaxDevices = 64;
constexpr int kWideFrames = 8;  // kF of every long-launch shape whose span fits
constexpr int kNarrowFrames = 4;
constexpr int kTinyFrames = 2;  // kF of the band launch
constexpr int kColsPerThread = 4;
constexpr int kStageUnroll = 4;  // float4 loads in flight a thread while a band CTA stages
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
  int fpt;         // frames a thread: kWideFrames or kNarrowFrames; the band launch kTinyFrames
  int ksplit;      // warps that share a unit, each summing a part of the rows
  int band_rows;   // rows of each tile's band in `band`
  int span;        // samples of the span of a CTA's frames (a multiple of 4)
  int stride;      // band launch: floats between two staged frames (hop: one run)
  int staged;      // floats of shared memory before the row split's sums
  int group;       // band launch: column tiles a CTA takes
};

__device__ __forceinline__ bool non_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}
// One float, or zero where `bytes` is 0 (`src` is then not read).
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The band launch's staging: rows [lo, lo + rows) of each of the CTA's
// frames (frame f's row lo + r at x[start + f*hop + lo + r]) into `xs`,
// frame f at f * stride, or, with stride == hop, as one run from row lo of
// frame 0; zero past n. One pass over the CTA's whole span [start, start +
// span) reads every sample once, kStageUnroll 16-byte loads in flight a
// thread, stores those of the band and notes any NaN or Inf among all of
// them. Returns this thread's note.
__device__ __forceinline__ bool stage_band(const float* __restrict__ x, long long n,
                                           long long start,
                           const Shape& s, int lo, int rows, float* xs) {
  const bool run = s.stride == s.hop;
  const int run_len = (s.frames - 1) * s.hop + rows;  // the run's floats
  if (start + (long long)(s.frames - 1) * s.hop + lo + rows > n) {
    for (int i = threadIdx.x; i < s.staged; i += blockDim.x) xs[i] = 0.0f;
    __syncthreads();
  }
  const long long avail = n - start;
  const int len = avail <= 0 ? 0 : (avail < s.span ? static_cast<int>(avail) : s.span);
  bool bad = false;
  // sample q of the span (q = position - start): its frame f and row r of
  // that frame's band are tracked from q0 on, one division per call
  auto put = [&](int q0, float4 v, int count) {
    int rel = q0 - lo;
    int f = 0, r = rel;
    if (!run && rel >= 0) {
      f = rel / s.hop;
      r = rel - f * s.hop;
    }
    bad |= non_finite(v.x) | non_finite(v.y) | non_finite(v.z) | non_finite(v.w);
    // four samples of one row run, 16-byte aligned in shared memory: one store
    if (count == 4 && rel >= 0 && (rel & 3) == 0 &&
        (run ? rel + 3 < run_len : (r & 3) == 0 && r + 3 < rows && f < s.frames)) {
      *reinterpret_cast<float4*>(xs + (run ? rel : f * s.stride + r)) = v;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j, ++rel, ++r) {
      if (j >= count) break;
      const float vj = j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
      if (rel < 0) continue;
      if (run) {
        if (rel < run_len) xs[rel] = vj;
      } else {
        if (r == s.hop) {
          r = 0;
          ++f;
        }
        if (f < s.frames && r < rows) xs[f * s.stride + r] = vj;
      }
    }
  };
  const float* src = x + start;
  // samples before the first 16-byte boundary, and after the last whole float4
  const int head = min(len, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4));
  const int n_vec = (len - head) / 4;
  const int tail = head + 4 * n_vec;
  for (int q = threadIdx.x; q < head; q += blockDim.x) {
    put(q, make_float4(__ldg(src + q), 0.0f, 0.0f, 0.0f), 1);
  }
  for (int q = tail + threadIdx.x; q < len; q += blockDim.x) {
    put(q, make_float4(__ldg(src + q), 0.0f, 0.0f, 0.0f), 1);
  }
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += blockDim.x * kStageUnroll) {
    float4 raw[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) raw[u] = __ldg(src4 + v);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) put(head + 4 * v, raw[u], 4);
    }
  }
  return bad;
}

// kSplit: `ksplit` warps share a unit (else s.ksplit is 1 and the code for it
// is compiled out: the registers it costs lose the resampler a CTA per SM).
// kF: frames a thread takes (s.fpt). kBand: the band launch (a group of
// column tiles a CTA, their bands staged alone), else the long launch.
template <bool kVec, bool kSplit, int kF, bool kBand>
__device__ __forceinline__ void framed_gemm_body(const float* __restrict__ x, long long n,
                                                 const float* __restrict__ g,
                                                 const float* __restrict__ band,
                                                 const int* __restrict__ ranges,
                                                 long long n_frames, float* __restrict__ out,
                                                 const Shape& s) {
  extern __shared__ __align__(16) float xs[];
  // the band launch's CTA takes one frame block and a group of s.group
  // column tiles (the last group may have fewer); the long launch's every tile
  const int n_groups = kBand ? (s.n_tiles + s.group - 1) / s.group : 1;
  const int tile0 = kBand ? static_cast<int>(blockIdx.x % n_groups) * s.group : 0;
  const int tiles_here = kBand ? min(s.group, s.n_tiles - tile0) : s.n_tiles;
  const long long f0 = (long long)(blockIdx.x / n_groups) * s.frames;
  const long long start = s.gap + f0 * s.hop;

  bool bad = false;
  int lo_g = 0;  // the band launch's first staged row of G
  if constexpr (kBand) {
    // the group's rows: from the first row of its first band to the end of
    // its last (the resampler's bands move down the window with the tile)
    int hi_g = 0;
    lo_g = INT_MAX;
    for (int t = tile0; t < tile0 + tiles_here; ++t) {
      const int lo = __ldg(ranges + 2 * t);
      const int rows = __ldg(ranges + 2 * t + 1);
      if (rows > 0) {
        lo_g = min(lo_g, lo);
        hi_g = max(hi_g, lo + rows);
      }
    }
    if (hi_g == 0) lo_g = 0;
    bad = stage_band(x, n, start, s, lo_g, hi_g - lo_g, xs);
  } else {
    // the span of this CTA's frames; zero past the end of x
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
  // the floats between two staged frames
  const int xstride = kBand ? s.stride : s.hop;

  // With ksplit > 1 a CTA has one warp per (unit, part of the rows) it can
  // have, so that every warp takes one and reaches the barrier of the
  // reduction below; a warp past the last unit (the band launch's last
  // group of tiles may be short) sums and stores nothing.
  const int ksplit = kSplit ? s.ksplit : 1;
  const int work = tiles_here * frame_blocks * ksplit;
  for (int w = warp; w < (kBand && kSplit ? warps : work); w += warps) {
    const bool live = !kBand || w < work;  // the long launch has a unit for every warp
    const int u = w / ksplit;
    const int part = w - u * ksplit;
    const int tile = live ? tile0 + u / frame_blocks : tile0;
    const int fb = u - (tile - tile0) * frame_blocks;
    const int fl = fb * unit_frames + fg;  // this thread's frames: fl + r*fgw
    const int c0 = tile * cw + ci;         // its columns: c0 + j*cg
    float acc[kF][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kF; ++r) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.0f;
    }
    if (live && dense) {
      // all rows of G, straight from the matrix; the band launch reads the
      // samples from device memory (it staged its band only)
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
          float xv;
          if constexpr (kBand) {
            const long long at = start + (long long)(fl + r * fgw) * s.hop + k;
            xv = at < n ? __ldg(x + at) : 0.0f;
          } else {
            xv = xs[(fl + r * fgw) * s.hop + k];
          }
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            acc[r][j] = fmaf(xv, gv[j], acc[r][j]);
          }
        }
      }
    } else if (live) {
      const int lo = __ldg(ranges + 2 * tile);
      const int rows = __ldg(ranges + 2 * tile + 1);  // a multiple of 4
      const float4* bt = reinterpret_cast<const float4*>(
                             band + (long long)tile * s.band_rows * cw) + ci;
      const float* xb = xs + fl * xstride + lo - lo_g;
      const int xstep = fgw * xstride;
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
      float* red = xs + s.staged;  // [warps][kF frames x 4 columns][32 lanes]
      constexpr int kTile = kF * kColsPerThread;
      if (live && part > 0) {
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          red[(w * kTile + q) * 32 + lane] = acc[q / kColsPerThread][q % kColsPerThread];
        }
      }
      __syncthreads();
      if (!live || part > 0) continue;
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

// The two launches' kernels (g [window, m], band [tiles, band_rows, 4*cg],
// ranges [tiles, 2]: lo, rows). The band launch's is declared for one CTA
// an SM at least: with no such bound ptxas held one of its instantiations
// to 64 registers and spilled; the long launch's keeps the registers that
// give it its CTAs an SM.
template <bool kVec, bool kSplit, int kF>
__global__ void __launch_bounds__(kMaxWarps * 32)
    framed_gemm_kernel(const float* __restrict__ x, long long n, const float* __restrict__ g,
                       const float* __restrict__ band, const int* __restrict__ ranges,
                       long long n_frames, float* __restrict__ out, Shape s) {
  framed_gemm_body<kVec, kSplit, kF, false>(x, n, g, band, ranges, n_frames, out, s);
}
template <bool kVec, bool kSplit, int kF>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    framed_gemm_band_kernel(const float* __restrict__ x, long long n,
                            const float* __restrict__ g, const float* __restrict__ band,
                            const int* __restrict__ ranges, long long n_frames,
                            float* __restrict__ out, Shape s) {
  framed_gemm_body<kVec, kSplit, kF, true>(x, n, g, band, ranges, n_frames, out, s);
}

// The slot form's staging of frame block `blk` into `dst`: warp w copies
// frames w, w + warps, ... each into its slot of s.stride floats (16 bytes
// a lane where the frame's first sample lies on 16 bytes and the slot ends
// before x does, else a float a lane, zero past n); one commit group.
__device__ __forceinline__ void stage_slots(const float* __restrict__ x, long long n,
                                            long long blk, const Shape& s, float* dst) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long first = s.gap + blk * s.frames * static_cast<long long>(s.hop);
  for (int f = warp; f < s.frames; f += warps) {
    const long long at = first + static_cast<long long>(f) * s.hop;
    const float* src = x + at;
    float* d = dst + f * s.stride;
    if (at + s.stride <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int i = 4 * lane; i < s.stride; i += 128) cp_async16(d + i, src + i);
    } else if (at + s.stride <= n) {
#pragma unroll 4
      for (int i = lane; i < s.stride; i += 32) cp_async4_zfill(d + i, src + i, 4);
    } else {
      for (int i = lane; i < s.stride; i += 32) {
        const bool in = at + i < n;
        cp_async4_zfill(d + i, in ? src + i : x, in ? 4 : 0);
      }
    }
  }
  cp_async_commit();
}

// The long launch's slot form (the note at the head of this file): a CTA
// walks frame blocks blockIdx.x, + gridDim.x, ..., two buffers of
// s.frames slots of s.stride floats, the next block's copy in flight while
// this one is summed. band [groups, band_rows, 4 * cg] and ranges [quads,
// 2] (first row, rows) are the column quads' bands, a group's cg quads side
// by side in each row. kF: frames a lane.
template <bool kSplit, int kF>
__global__ void __launch_bounds__(kMaxSlotWarps * 32, 1)
    framed_gemm_slot_kernel(const float* __restrict__ x, long long n,
                            const float* __restrict__ g, const float* __restrict__ band,
                            const int* __restrict__ ranges, long long n_frames,
                            float* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) float xs[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int fpw = 32 / s.cg;  // lanes across frames; s.cg across column quads
  const int fi = lane & (fpw - 1);
  const int qi = lane / fpw;
  const int n_quads = (s.m + kColsPerThread - 1) / kColsPerThread;
  const int slots = s.frames * s.stride;  // floats of one buffer
  const long long blocks = (n_frames + s.frames - 1) / s.frames;
  const int ksplit = kSplit ? s.ksplit : 1;
  const int items = s.n_tiles * ksplit;  // (group of quads, part of the rows)

  long long blk = blockIdx.x;
  if (blk < blocks) stage_slots(x, n, blk, s, xs);
  for (int j = 0; blk < blocks; blk += gridDim.x, ++j) {
    const float* cur = xs + (j & 1) * slots;
    if (blk + gridDim.x < blocks) {
      stage_slots(x, n, blk + gridDim.x, s, xs + ((j + 1) & 1) * slots);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the non-finite rule on this block's slots: v * 0 is NaN for a NaN or
    // an Inf and +-0 else, so `probe` ends NaN exactly where one is staged
    float probe = 0.0f;
    const float4* cur4 = reinterpret_cast<const float4*>(cur);
    for (int i = threadIdx.x; i < slots / 4; i += blockDim.x) {
      const float4 v = cur4[i];
      probe = fmaf(v.x, 0.0f, probe);
      probe = fmaf(v.y, 0.0f, probe);
      probe = fmaf(v.z, 0.0f, probe);
      probe = fmaf(v.w, 0.0f, probe);
    }
    const bool dense = __syncthreads_or(probe != probe);
    const long long f0 = blk * s.frames;

    for (int w = warp; w < (kSplit ? warps : items); w += warps) {
      const int grp = w / ksplit;
      const int part = w - grp * ksplit;
      const int q = grp * s.cg + qi;  // this lane's quad: columns 4q .. 4q + 3
      const bool live = q < n_quads;
      const float* xf = cur + fi * s.stride;  // frame fi's slot; frame fi + r*fpw at r*xstep
      const int xstep = fpw * s.stride;
      float acc[kF][kColsPerThread];
#pragma unroll
      for (int r = 0; r < kF; ++r) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;
      }
      if (live && dense) {
        // all rows of G, straight from the matrix
        int gcol[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) gcol[c] = min(q * kColsPerThread + c, s.m - 1);
        const int chunk = (s.window + ksplit - 1) / ksplit;
        const int k_end = min(s.window, (part + 1) * chunk);
        for (int k = part * chunk; k < k_end; ++k) {
          float gv[kColsPerThread];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) gv[c] = __ldg(g + (long long)k * s.m + gcol[c]);
#pragma unroll
          for (int r = 0; r < kF; ++r) {
            const float xv = xf[r * xstep + k];
#pragma unroll
            for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fmaf(xv, gv[c], acc[r][c]);
          }
        }
      } else if (live) {
        const int lo = __ldg(ranges + 2 * q);
        const int rows = __ldg(ranges + 2 * q + 1);  // a multiple of 4, the same across the warp
        // row k of this quad's band at bq[k * cg]: a warp's quads side by side
        const float4* bq =
            reinterpret_cast<const float4*>(band) + (long long)grp * s.band_rows * s.cg + qi;
        const float* xb = xf + lo;
        const int chunk = ((rows + ksplit - 1) / ksplit + 3) / 4 * 4;
        const int k_end = min(rows, (part + 1) * chunk);
        int k = part * chunk;
        // G's next four rows are loaded while these four are summed
        float4 gn[4];
        if (k < k_end) {
#pragma unroll
          for (int t = 0; t < 4; ++t) gn[t] = __ldg(bq + (k + t) * s.cg);
        }
        for (; k < k_end; k += 4) {
          float4 gv[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) gv[t] = gn[t];
          if (k + 4 < k_end) {
#pragma unroll
            for (int t = 0; t < 4; ++t) gn[t] = __ldg(bq + (k + 4 + t) * s.cg);
          }
#pragma unroll
          for (int r = 0; r < kF; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(xb + r * xstep + k);
            const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              acc[r][0] = fmaf(xv[t], gv[t].x, acc[r][0]);
              acc[r][1] = fmaf(xv[t], gv[t].y, acc[r][1]);
              acc[r][2] = fmaf(xv[t], gv[t].z, acc[r][2]);
              acc[r][3] = fmaf(xv[t], gv[t].w, acc[r][3]);
            }
          }
        }
      }
      if (kSplit) {
        // the parts' sums meet in shared memory after both buffers and are
        // added in the order of the rows by the warp of part 0
        float* red = xs + 2 * slots;  // [warps][kF frames x 4 columns][32 lanes]
        constexpr int kTile = kF * kColsPerThread;
        if (part > 0) {
#pragma unroll
          for (int t = 0; t < kTile; ++t) {
            red[(w * kTile + t) * 32 + lane] = acc[t / kColsPerThread][t % kColsPerThread];
          }
        }
        __syncthreads();
        if (part > 0) continue;
        for (int p = 1; p < ksplit; ++p) {
#pragma unroll
          for (int t = 0; t < kTile; ++t) {
            acc[t / kColsPerThread][t % kColsPerThread] += red[((w + p) * kTile + t) * 32 + lane];
          }
        }
      }
      // The warp's tile is fpw * kF frames x 4 * cg neighbouring columns;
      // shuffled so that a store covers whole rows of it (32 / (4 * cg)
      // rows of 16 * cg bytes), not one column of each lane's quad.
      const int cols = kColsPerThread * s.cg;
      const int col = lane % cols;
      const int c = grp * cols + col;
#pragma unroll
      for (int r = 0; r < kF; ++r) {
#pragma unroll
        for (int part4 = 0; part4 < 4; ++part4) {
          const int row = part4 * (32 / cols) + lane / cols;  // of fpw rows
          const int src = row + fpw * (col / kColsPerThread);
          const float v0 = __shfl_sync(0xffffffffu, acc[r][0], src);
          const float v1 = __shfl_sync(0xffffffffu, acc[r][1], src);
          const float v2 = __shfl_sync(0xffffffffu, acc[r][2], src);
          const float v3 = __shfl_sync(0xffffffffu, acc[r][3], src);
          const int e = col & 3;
          const float v = e == 0 ? v0 : e == 1 ? v1 : e == 2 ? v2 : v3;
          const long long f = f0 + row + r * fpw;
          if (f < n_frames && c < s.m) out[f * s.m + c] = v;
        }
      }
    }
    // every warp is done with this buffer (and the row split's sums) before
    // the next block's copy into it is issued
    __syncthreads();
  }
}

using KernelFn = void (*)(const float*, long long, const float*, const float*, const int*,
                          long long, float*, Shape);

// The three forms: the long launch's run and slots, the band launch.
enum Form { kRun = 0, kBandForm = 1, kSlots = 2 };

template <int kForm, bool kVec, bool kSplit, int kF>
KernelFn kernel_of() {
  if constexpr (kForm == kBandForm) {
    return framed_gemm_band_kernel<kVec, kSplit, kF>;
  } else if constexpr (kForm == kSlots) {
    return framed_gemm_slot_kernel<kSplit, kF>;
  } else {
    return framed_gemm_kernel<kVec, kSplit, kF>;
  }
}

// The staged samples, and with a row split one register tile per thread.
size_t smem_bytes(const Shape& s, int threads) {
  const size_t red = s.ksplit > 1
      ? static_cast<size_t>(threads) * s.fpt * kColsPerThread : 0;
  return (static_cast<size_t>(s.staged) + red) * sizeof(float);
}

// Shared memory above 48 KB has to be opted in to; the opt-in is a maximum,
// raised once per kernel instantiation, device and size.
template <int kForm, bool kVec, bool kSplit, int kF>
cudaError_t opt_in(int device, size_t smem) {
  static std::mutex mutex;
  static size_t granted[kMaxDevices] = {};
  if (static_cast<long long>(smem) <= kSmemDefault) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mutex);
  if (device >= 0 && device < kMaxDevices && smem <= granted[device]) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_of<kForm, kVec, kSplit, kF>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    granted[device] = smem;
  }
  return err;
}

template <int kForm, bool kVec, bool kSplit, int kF>
int launch(const float* x, long long n, const float* g, const float* band,
           const int* ranges, long long n_frames, float* out, const Shape& s,
           int threads, long long ctas, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(s, threads);
  const cudaError_t err = opt_in<kForm, kVec, kSplit, kF>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel_of<kForm, kVec, kSplit, kF>()<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(
      x, n, g, band, ranges, n_frames, out, s);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm, int kF>
int launch_vs(bool vec, int ksplit, const float* x, long long n, const float* g,
              const float* band, const int* ranges, long long n_frames, float* out,
              const Shape& s, int threads, long long ctas, int device, cudaStream_t stream) {
#define SD_LAUNCH(V, S) \
  launch<kForm, V, S, kF>(x, n, g, band, ranges, n_frames, out, s, threads, ctas, device, stream)
  if constexpr (kForm == kSlots) {  // slots are always read as float4
    return ksplit > 1 ? SD_LAUNCH(true, true) : SD_LAUNCH(true, false);
  } else {
    return ksplit > 1 ? (vec ? SD_LAUNCH(true, true) : SD_LAUNCH(false, true))
                      : (vec ? SD_LAUNCH(true, false) : SD_LAUNCH(false, false));
  }
#undef SD_LAUNCH
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
// `fpt` frames a thread, `frames` frames per CTA (a multiple of fpt * 32 /
// cg), `threads` per CTA (whole warps); `band` and `ranges` (first row, row
// count, both multiples of 4) are G's bands as the note at the head of this
// file lays them out, device pointers. `band_launch` 0 takes the long
// launch: with `stride` 0 its run form (`band` [tiles, band_rows, 4 * cg],
// fpt 8 or 4, at most 256 threads; `vec` reads the run as float4 along k
// and needs hop % 4 == 0), with `stride` > 0 its slot form (`band`
// [groups, band_rows, 4 * cg], ranges [quads, 2], the rows of each group of cg
// quads as deep; cg 1, 2 or 4, fpt 4, 2 or 1, frames fpt * 32 / cg, at
// most 512 threads; a slot of `stride` floats, a multiple of 4 of at least
// the window rounded up to 4, a frame; `ctas` CTAs walk the frame blocks).
// `band_launch` 1 takes the band launch (`band` as the run form's, fpt 2, a
// CTA one unit of frames of `group` tiles, their `stage_rows` rows staged
// at `stride` floats a frame: `stride` == hop stages one run, else stride
// >= stage_rows, a multiple of 4, needs hop >= stage_rows; `vec` needs a
// stride % 4 == 0). Returns cudaErrorInvalidValue for a geometry it cannot
// launch (among them samples that do not fit in shared memory), else
// cudaGetLastError() after the launch: 0 when the launch was taken.
int sd_framed_gemm(const float* x, long long n, const float* g, int window,
                   int m, int hop, int gap, long long n_frames, float* out,
                   const float* band, const int* ranges, int band_rows, int cg,
                   int ksplit, int fpt, int frames, int threads, int vec,
                   int band_launch, int group, int stage_rows, int stride, int ctas,
                   int device, void* stream) {
  const bool slots = band_launch == 0 && stride > 0;
  const bool fpt_ok = band_launch ? fpt == kTinyFrames
                      : slots     ? fpt == 4 || fpt == 2 || fpt == 1
                                  : fpt == kWideFrames || fpt == kNarrowFrames;
  const int max_warps = slots ? kMaxSlotWarps : kMaxWarps;
  if (window < 1 || m < 1 || hop < 1 || gap < 0 || n < 0 || n_frames < 1 ||
      (cg != 1 && cg != 2 && cg != 4 && cg != 8) || (slots && cg == 8) || band_rows < 0 ||
      band_rows % 4 != 0 || threads < 32 || threads > max_warps * 32 ||
      threads % 32 != 0 || frames < 1 || ksplit < 1 || !fpt_ok ||
      frames % (fpt * 32 / cg) != 0 || (slots && frames != fpt * 32 / cg) ||
      (band_launch != 0 && band_launch != 1)) {
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
  s.group = band_launch ? group : s.n_tiles;
  if (s.group < 1 || s.group > s.n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  // a row split needs one warp for each part of each unit a CTA can have
  const int units = s.group * (frames / (fpt * 32 / cg));
  if (ksplit > 1 && units * ksplit != threads / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the last frame's rows run to lo + rows <= window + 6 (both rounded to 4)
  const long long span = ((long long)(frames - 1) * hop + window + 8 + 3) / 4 * 4;
  long long staged = span;
  if (band_launch) {
    if (stage_rows < 0 || stage_rows % 4 != 0 || stage_rows > window + 3) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (stride == hop) {
      staged = ((long long)(frames - 1) * hop + stage_rows + 3) / 4 * 4;
      if (vec && hop % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (stride < stage_rows || stride % 4 != 0 || hop < stage_rows) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      staged = (long long)frames * stride;
    }
  } else if (slots) {
    if (stride % 4 != 0 || stride < (window + 3) / 4 * 4 || ctas < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    staged = 2LL * frames * stride;  // two buffers
  } else if (vec && hop % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (span > INT_MAX || staged > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  s.span = static_cast<int>(span);
  s.stride = band_launch || slots ? stride : 0;
  s.staged = static_cast<int>(staged);
  if (static_cast<long long>(smem_bytes(s, threads)) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_frames + frames - 1) / frames;
  const long long grid =
      slots ? (ctas < blocks ? ctas : blocks) : blocks * ((s.n_tiles + s.group - 1) / s.group);
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
#define SD_ARGS v, ksplit, x, n, g, band, ranges, n_frames, out, s, threads, grid, device, st
  if (band_launch) return launch_vs<kBandForm, kTinyFrames>(SD_ARGS);
  if (slots) {
    return fpt == 4 ? launch_vs<kSlots, 4>(SD_ARGS)
           : fpt == 2 ? launch_vs<kSlots, 2>(SD_ARGS)
                      : launch_vs<kSlots, 1>(SD_ARGS);
  }
  return fpt == kWideFrames ? launch_vs<kRun, kWideFrames>(SD_ARGS)
                            : launch_vs<kRun, kNarrowFrames>(SD_ARGS);
#undef SD_ARGS
}

}  // extern "C"
