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
// Design: the grid is (tiles of frames, tiles of columns). A CTA stages the
// contiguous input span its frames cover, (frames - 1) * hop + window
// samples, in shared memory with coalesced loads, zero-filling past n. Its
// 256 threads form a [256 / tc, tc] grid: tc threads across columns, each
// owning rn columns (c0 + t, c0 + t + tc, ...), and 256 / tc threads across
// frames, each owning kFramesPerThread frames (r0, r0 + 256 / tc, ...). For
// each of the window's rows a thread reads its rn values of G through the
// read-only path (a warp reads consecutive columns of one row, and every
// warp of the CTA reads the same rows, so they hit L1) and its frames'
// samples from shared memory (one address per frame row, a broadcast), and
// does kFramesPerThread * rn FMAs. The sum over the window runs in a fixed
// order in fp32 FMAs, with no TF32, as Precision.HIGHEST asks of the JAX
// kernel. The TPU kernel's slab parts (frame k's column block j is row
// k + j of the [rows, hop] slab) exist for its layout and are not carried
// over: the staged span is indexed directly.
//
// Geometry is set at run time. Wide products (m > 32, the resampler's up
// factor for most rate pairs: 147, 160, 441) use tc = 32 and rn = 4, so a
// CTA covers 32 frames and 128 columns, and the column tiles run across
// grid.y. Narrow ones (m <= 32, such as 22.05k -> 44.1k with m = 2 and
// hop 1, where frames are one sample apart) use tc = the next power of two
// >= m and rn = 1, so a CTA covers up to 1024 frames and the warp's
// threads read neighbouring samples. Frames per CTA are halved until the
// staged span fits in shared memory; a span above 48 KB opts in to more.
//
// What bounds it on the card: 2 * window * m FLOPs per frame against hop
// new samples (at 48k -> 44.1k, 53 kFLOP per 640 bytes of input), so it is
// compute-bound; the dense product does every multiply by G's zeros too
// (G is ~12 % non-zero). Each FMA here costs a shared and a global load
// per kFramesPerThread * rn FMAs; tensor-core tiles (3xTF32) and skipping
// G's zero blocks are later work.

#include <cuda_runtime.h>

#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerThread = 4;
constexpr long long kSmemLimit = 232448;  // bytes one block may opt in to
constexpr long long kSmemDefault = 48 * 1024;

struct Plan {
  int tc;          // threads across columns
  int rn;          // columns per thread
  int frames;      // frames per CTA
  int cols;        // columns per CTA
  long long span;  // samples staged per CTA
};

Plan make_plan(int window, int m, int hop) {
  Plan p;
  if (m > 32) {
    p.tc = 32;
    p.rn = 4;
  } else {
    p.tc = 1;
    while (p.tc < m) p.tc <<= 1;
    p.rn = 1;
  }
  p.cols = p.tc * p.rn;
  p.frames = (kThreads / p.tc) * kFramesPerThread;
  while (p.frames > 1 &&
         ((long long)(p.frames - 1) * hop + window) * (long long)sizeof(float) >
             kSmemLimit) {
    p.frames /= 2;
  }
  p.span = (long long)(p.frames - 1) * hop + window;
  return p;
}

template <int RN>
__global__ void __launch_bounds__(kThreads)
    framed_gemm_kernel(const float* __restrict__ x, long long n,
                       const float* __restrict__ g, int window, int m,
                       int hop, int gap, long long n_frames,
                       float* __restrict__ out, int tc, int frames, int span) {
  extern __shared__ float xs[];
  const long long f0 = (long long)blockIdx.x * frames;
  const long long start = gap + f0 * hop;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long s = start + i;
    xs[i] = s < n ? x[s] : 0.0f;
  }
  __syncthreads();

  const int tcol = threadIdx.x % tc;
  const int trow = threadIdx.x / tc;
  const int rows = kThreads / tc;
  const int c0 = blockIdx.y * tc * RN + tcol;

  // Frames and columns past the edge read clamped, valid addresses; their
  // sums are never stored.
  int xoff[kFramesPerThread];
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r) {
    xoff[r] = min(trow + rows * r, frames - 1) * hop;
  }
  int gcol[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) gcol[j] = min(c0 + tc * j, m - 1);

  float acc[kFramesPerThread][RN];
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[r][j] = 0.0f;
  }

  const float* grow = g;
  for (int k = 0; k < window; ++k, grow += m) {
    float gv[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) gv[j] = __ldg(grow + gcol[j]);
    float xv[kFramesPerThread];
#pragma unroll
    for (int r = 0; r < kFramesPerThread; ++r) xv[r] = xs[xoff[r] + k];
#pragma unroll
    for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[r][j] = fmaf(xv[r], gv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r) {
    const int fl = trow + rows * r;
    const long long f = f0 + fl;
    if (fl >= frames || f >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = c0 + tc * j;
      if (c < m) out[f * m + c] = acc[r][j];
    }
  }
}

template <int RN>
int launch(const float* x, long long n, const float* g, int window, int m,
           int hop, int gap, long long n_frames, float* out, const Plan& p,
           dim3 grid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.span) * sizeof(float);
  if (static_cast<long long>(smem) > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        framed_gemm_kernel<RN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  framed_gemm_kernel<RN><<<grid, kThreads, smem, stream>>>(
      x, n, g, window, m, hop, gap, n_frames, out, p.tc, p.frames,
      static_cast<int>(p.span));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* sd_framed_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream` (device `device`): x [n] float32, g
// [window, m] float32 row-major, out [n_frames, m] float32, all device
// pointers. Frame k reads x[gap + k*hop + i], i < window. Returns
// cudaErrorInvalidValue for a geometry it cannot launch (among them a
// window that does not fit in shared memory), else cudaGetLastError()
// after the launch: 0 when the launch was taken.
int sd_framed_gemm(const float* x, long long n, const float* g, int window,
                   int m, int hop, int gap, long long n_frames, float* out,
                   int device, void* stream) {
  if (window < 1 || m < 1 || hop < 1 || gap < 0 || n < 0 || n_frames < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(window, m, hop);
  if (p.span * (long long)sizeof(float) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gx = (n_frames + p.frames - 1) / p.frames;
  const long long gy = (m + p.cols - 1) / p.cols;
  if (gx > INT_MAX || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.rn == 4) {
    return launch<4>(x, n, g, window, m, hop, gap, n_frames, out, p, grid, st);
  }
  return launch<1>(x, n, g, window, m, hop, gap, n_frames, out, p, grid, st);
}

}  // extern "C"
