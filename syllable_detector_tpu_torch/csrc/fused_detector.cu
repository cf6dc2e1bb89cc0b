// Fused syllable-detector kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of syllable_detector_tpu/kernels/
// fused_detector.py (_make_kernel, launched by _fused_call through
// pl.pallas_call) in its full-fp32 raw-sample forms: one stream
// (fused_offline_outputs, K1a), a [lanes, n] batch of streams with one
// shared net or one net per lane (fused_flat_batch_offline_outputs /
// _flat_core, K1e), and that batch read from an int16 or 8-bit mu-law wire
// and dequantised on the card (fused_batch_program, K1f). For every
// evaluation e of a lane it computes, without writing any intermediate to
// device memory:
//
//   frames  x[e*hop + gap + i], i < window      (hop-strided, zero past n)
//   band    re|im = frame @ C, C = [window, 2*bins] with the hamming window
//           folded in; |X| = sqrt(re^2 + im^2)
//   scaling linear, log(|X|), or dB as 20/ln(10) * log(|X|)
//   layer 1 conv = sum_t sum_k spec[e+t, k] * W1'[t, k, :] (the first layer
//           as a T-tap convolution over frames; input affines folded in)
//   l2      conv / sqrt(sum_t rowsq[e+t]) when the input chain starts with
//           l2normalize; no epsilon, so digital silence gives 0/0 = NaN as
//           in the JAX package, and a NaN output never crosses a threshold
//   MLP     + c1, transfer, hidden layers, then the folded output affine
//           y * out_a + out_c
//
// Design: the grid is (tiles of evaluations, lanes). A CTA handles one tile
// (32 evaluations, fewer for small drains, set by the wrapper) of one lane.
// It stages the contiguous sample span of its tile + T - 1 frames in shared
// memory (coalesced loads), dequantising wire samples as it stores them, so
// a drain round is one launch and only the wire bytes cross PCIe. It then
// computes the scaled spectrogram of those frames and their row sums of
// squares into shared memory, then the per-evaluation first layer, hidden
// layers and output affine. The per-net operands carry a lane stride (0 for
// a shared net; C is always shared). A thread transforms kFrames frames of
// one bin at once, and splits the first layer's dot product into kPartials
// sums, so that its chains of dependent loads and FMAs stay short: with few
// CTAs in flight (a CLI chunk is 16 CTAs on 132 SMs) those chains, not
// throughput, set the time. Geometry, layer widths and transfer codes are
// runtime values, so one build serves every net the fused path accepts.
//
// What bounds it on the card: the band DFT is ~15k fp32 MACs per evaluation
// (2 * bins * window at the sample geometry) against one hop of new audio
// (528 bytes as float32, 264 as int16), so it is compute- and not
// bandwidth-bound. Measured on an H100, the DFT stage takes ~3/4 of a CTA's
// cycles, waiting on L2: a CTA reads each row of C (59 KB at the sample
// geometry) once, so each C load misses L1. Staging C through shared memory
// in row blocks, the DFT as 3xTF32 wgmma GEMMs fed by TMA, and a CUDA graph
// per drain bucket are later work.
//
// Built without --use_fast_math on purpose: tanhf, expf, expm1f, logf,
// sqrtf and the division keep their IEEE behaviour, including the NaN on
// silence. The dequantising products are __fmul_rn, so they are never
// contracted into an FMA: the int16 wire is bit-exact with the JAX program.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;
// Consecutive frames one thread transforms for one bin: 2 * kFrames
// independent accumulators, and each C value loaded once serves kFrames.
constexpr int kFrames = 8;
// Partial sums of the first layer's dot product, for the same reason.
constexpr int kPartials = 4;
constexpr float kDbPerNeper = 8.685889638065037f;  // 20 / ln(10)

enum Scaling { kLinear = 0, kLog = 1, kDb = 2 };
enum Transfer { kPureLin = 0, kTanSig = 1, kLogSig = 2, kSatLin = 3 };

struct Geometry {
  int window;
  int hop;
  int gap;
  int bins;
  int time_range;
  int scaling;
  int has_l2;
  int tile;
  int max_width;
};

struct NetMeta {
  int n_layers;              // layers of the MLP, the first one included
  int widths[kMaxLayers];    // output width of each layer
  int transfers[kMaxLayers]; // Transfer code of each layer
};

// Elements between one lane's net operands and the next: 0 for a shared
// net, one net's size for per-lane nets.
struct LaneStrides {
  long long w1;
  long long c1;
  long long mids;
  long long out;  // out_a and out_c
};

enum Wire { kFloat32 = 0, kInt16 = 1, kMulaw8 = 2 };

// The wire's dequantising constants, float32 values handed in by the
// wrapper so that they are the JAX program's own: int16 x * scale with
// scale = 1/32767; mu-law y = x * scale (scale = 1/127), then
// sign(y) * expm1(|y| * ln1mu) * inv_mu (ln1mu = ln 256, inv_mu = 1/255).
struct Dequant {
  float scale;
  float ln1mu;
  float inv_mu;
};

__device__ __forceinline__ float dequant(float v, const Dequant&) { return v; }

__device__ __forceinline__ float dequant(int16_t v, const Dequant& d) {
  return __fmul_rn(static_cast<float>(v), d.scale);
}

__device__ __forceinline__ float dequant(int8_t v, const Dequant& d) {
  const float y = __fmul_rn(static_cast<float>(v), d.scale);
  const float m = __fmul_rn(expm1f(__fmul_rn(fabsf(y), d.ln1mu)), d.inv_mu);
  return y > 0.0f ? m : (y < 0.0f ? -m : 0.0f);  // sign(y) * m
}

// Frames a CTA transforms: its tile + T - 1, rounded up to whole groups of
// kFrames (the extra frames read zeros past the span and are never used).
__host__ __device__ inline int padded_frames(const Geometry& g) {
  const int frames = g.tile + g.time_range - 1;
  return (frames + kFrames - 1) / kFrames * kFrames;
}

__host__ __device__ inline long long span_floats(const Geometry& g) {
  return (long long)(padded_frames(g) - 1) * g.hop + g.gap + g.window;
}

__host__ __device__ inline long long smem_floats(const Geometry& g) {
  const long long frames = padded_frames(g);
  return span_floats(g) + frames * g.bins + frames +
         2LL * g.tile * g.max_width;
}

__device__ __forceinline__ float apply_transfer(float x, int code) {
  switch (code) {
    case kTanSig:
      return tanhf(x);
    case kLogSig:
      return 1.0f / (1.0f + expf(-x));  // the reference's composition
    case kSatLin:
      return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);  // NaN passes through
    default:
      return x;
  }
}

template <typename Sample>
__global__ void __launch_bounds__(kThreads) fused_detector_kernel(
    const Sample* __restrict__ x,         // [lanes, ld]: lane samples on the wire
    long long ld, long long n, long long n_evals,
    const float* __restrict__ c,     // [window, 2*bins]: re | im, shared
    const float* __restrict__ w1,    // per net [T*bins, h1]
    const float* __restrict__ c1,    // per net [h1]
    const float* __restrict__ mids,  // per net, per hidden layer: W [in, out], b [out]
    const float* __restrict__ out_a, const float* __restrict__ out_c,
    float* __restrict__ out,         // [lanes, n_evals, outputs]
    Geometry g, NetMeta net, LaneStrides ls, Dequant dq) {
  extern __shared__ float smem[];
  const long long lane = blockIdx.y;
  x += lane * ld;
  w1 += lane * ls.w1;
  c1 += lane * ls.c1;
  mids += lane * ls.mids;
  out_a += lane * ls.out;
  out_c += lane * ls.out;
  out += lane * n_evals * net.widths[net.n_layers - 1];
  const int b = g.bins;
  const int T = g.time_range;
  const int n_frames = g.tile + T - 1;
  const int frames_pad = padded_frames(g);
  const int mw = g.max_width;
  const long long span = span_floats(g);
  float* samples = smem;
  float* spec = samples + span;           // [frames_pad, bins]
  float* rowsq = spec + frames_pad * b;   // [frames_pad]
  float* act_a = rowsq + frames_pad;      // [tile, max_width]
  float* act_b = act_a + g.tile * mw;     // [tile, max_width]

  const long long e0 = (long long)blockIdx.x * g.tile;
  const long long start = e0 * g.hop;

  // 1. this tile's sample span, dequantised; reads past the stream are zero
  for (long long i = threadIdx.x; i < span; i += blockDim.x) {
    const long long j = start + i;
    samples[i] = j < n ? dequant(x[j], dq) : 0.0f;
  }
  __syncthreads();

  // 2. band DFT -> |X| -> scaling. One item is bin k of kFrames consecutive
  //    frames; neighbouring threads take neighbouring bins of the same
  //    frames, so the sample reads broadcast and the C reads coalesce.
  const int two_b = 2 * b;
  const int groups = frames_pad / kFrames;
  for (int p = threadIdx.x; p < groups * b; p += blockDim.x) {
    const int grp = p / b;
    const int k = p - grp * b;
    const int f0 = grp * kFrames;
    const float* base = samples + (long long)f0 * g.hop + g.gap;
    const float* col = c + k;
    float re[kFrames];
    float im[kFrames];
#pragma unroll
    for (int r = 0; r < kFrames; ++r) {
      re[r] = 0.0f;
      im[r] = 0.0f;
    }
    for (int i = 0; i < g.window; ++i) {
      const float cr = __ldg(col + i * two_b);
      const float ci = __ldg(col + i * two_b + b);
#pragma unroll
      for (int r = 0; r < kFrames; ++r) {
        const float v = base[r * g.hop + i];
        re[r] = fmaf(v, cr, re[r]);
        im[r] = fmaf(v, ci, im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFrames; ++r) {
      float s = sqrtf(re[r] * re[r] + im[r] * im[r]);
      if (g.scaling == kLog) {
        s = logf(s);
      } else if (g.scaling == kDb) {
        s = kDbPerNeper * logf(s);
      }
      spec[(f0 + r) * b + k] = s;
    }
  }
  __syncthreads();

  // 3. per-frame row sums of squares, for the sliding l2 norm
  if (g.has_l2) {
    for (int f = threadIdx.x; f < n_frames; f += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < b; ++k) {
        const float v = spec[f * b + k];
        acc = fmaf(v, v, acc);
      }
      rowsq[f] = acc;
    }
    __syncthreads();
  }

  // 4. first layer: the feature vector of evaluation e is spectrogram rows
  //    e .. e+T-1, contiguous in shared memory, so the T-tap convolution is
  //    one dot product of length T*bins per hidden unit
  const int h1 = net.widths[0];
  const int n_feat = T * b;
  for (int p = threadIdx.x; p < g.tile * h1; p += blockDim.x) {
    const int e = p / h1;
    const int j = p - e * h1;
    const float* feat = spec + e * b;
    float part[kPartials] = {};
    int d = 0;
    for (; d + kPartials <= n_feat; d += kPartials) {
#pragma unroll
      for (int q = 0; q < kPartials; ++q) {
        part[q] = fmaf(feat[d + q], __ldg(w1 + (d + q) * h1 + j), part[q]);
      }
    }
    for (; d < n_feat; ++d) {
      part[0] = fmaf(feat[d], __ldg(w1 + d * h1 + j), part[0]);
    }
    float acc = part[0];
#pragma unroll
    for (int q = 1; q < kPartials; ++q) acc += part[q];
    if (g.has_l2) {
      float norm = 0.0f;
      for (int t = 0; t < T; ++t) norm += rowsq[e + t];
      acc = acc / sqrtf(norm);
    }
    act_a[e * mw + j] = apply_transfer(acc + __ldg(c1 + j), net.transfers[0]);
  }
  __syncthreads();

  // 5. hidden layers
  float* a_in = act_a;
  float* a_out = act_b;
  const float* wl = mids;
  for (int l = 1; l < net.n_layers; ++l) {
    const int in_w = net.widths[l - 1];
    const int out_w = net.widths[l];
    const float* bl = wl + in_w * out_w;
    for (int p = threadIdx.x; p < g.tile * out_w; p += blockDim.x) {
      const int e = p / out_w;
      const int o = p - e * out_w;
      float z = 0.0f;
      for (int i = 0; i < in_w; ++i) {
        z = fmaf(a_in[e * mw + i], __ldg(wl + i * out_w + o), z);
      }
      a_out[e * mw + o] = apply_transfer(z + __ldg(bl + o), net.transfers[l]);
    }
    __syncthreads();
    float* tmp = a_in;
    a_in = a_out;
    a_out = tmp;
    wl = bl + out_w;
  }

  // 6. folded output affine; evaluations past the stream are not stored
  const int n_out = net.widths[net.n_layers - 1];
  for (int p = threadIdx.x; p < g.tile * n_out; p += blockDim.x) {
    const int e = p / n_out;
    const int o = p - e * n_out;
    const long long ev = e0 + e;
    if (ev < n_evals) {
      out[ev * n_out + o] = a_in[e * mw + o] * __ldg(out_a + o) + __ldg(out_c + o);
    }
  }
}

template <typename Sample>
int launch(const void* x, int lanes, long long ld, long long n,
           long long n_evals, const float* c, const float* w1,
           const float* c1, const float* mids, const float* out_a,
           const float* out_c, float* out, const Geometry& g,
           const NetMeta& net, const LaneStrides& ls, const Dequant& dq,
           size_t smem, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // kernel opts in first
  cudaError_t err = cudaFuncSetAttribute(
      fused_detector_kernel<Sample>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_evals + g.tile - 1) / g.tile),
                  static_cast<unsigned>(lanes));
  fused_detector_kernel<Sample><<<grid, kThreads, smem, stream>>>(
      static_cast<const Sample*>(x), ld, n, n_evals, c, w1, c1, mids, out_a,
      out_c, out, g, net, ls, dq);
  return static_cast<int>(cudaGetLastError());
}

Geometry make_geometry(int window, int hop, int gap, int bins, int time_range,
                       int scaling, int has_l2, int tile, int max_width) {
  Geometry g;
  g.window = window;
  g.hop = hop;
  g.gap = gap;
  g.bins = bins;
  g.time_range = time_range;
  g.scaling = scaling;
  g.has_l2 = has_l2;
  g.tile = tile;
  g.max_width = max_width;
  return g;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that one CTA of the kernel needs.
long long sd_fused_detector_smem_bytes(int window, int hop, int gap, int bins,
                                       int time_range, int tile,
                                       int max_width) {
  const Geometry g = make_geometry(window, hop, gap, bins, time_range, 0, 0,
                                   tile, max_width);
  return smem_floats(g) * (long long)sizeof(float);
}

int sd_max_layers() { return kMaxLayers; }

const char* sd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream` (device `device`) for `lanes` streams of
// `n` samples each, lane l at x + l * ld, as wire type `wire` (a Wire
// code). All pointers are device pointers except `widths` and `transfers`,
// host arrays of n_layers ints. `per_lane_nets` is 0 when every lane shares
// one net and 1 when the net operands hold one net per lane, stacked.
// Returns cudaGetLastError() after the launch: 0 when the launch was taken.
int sd_fused_detector(const void* x, int wire, int lanes, long long ld,
                      long long n, long long n_evals, const float* c,
                      const float* w1, const float* c1, const float* mids,
                      const float* out_a, const float* out_c, float* out,
                      int per_lane_nets, int window, int hop, int gap,
                      int bins, int time_range, int scaling, int has_l2,
                      int tile, int n_layers, const int* widths,
                      const int* transfers, float dq_scale, float dq_ln1mu,
                      float dq_inv_mu, int device, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || tile < 1 || n_evals < 1 ||
      lanes < 1 || lanes > 65535 || n < 0 || ld < n ||
      (n_evals + tile - 1) / tile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NetMeta net;
  net.n_layers = n_layers;
  int max_width = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    net.widths[l] = l < n_layers ? widths[l] : 0;
    net.transfers[l] = l < n_layers ? transfers[l] : 0;
    if (net.widths[l] > max_width) max_width = net.widths[l];
  }
  const Geometry g = make_geometry(window, hop, gap, bins, time_range,
                                   scaling, has_l2, tile, max_width);
  const size_t smem = static_cast<size_t>(smem_floats(g)) * sizeof(float);

  LaneStrides s = {0, 0, 0, 0};
  if (per_lane_nets) {
    s.w1 = static_cast<long long>(time_range) * bins * net.widths[0];
    s.c1 = net.widths[0];
    for (int l = 1; l < n_layers; ++l) {
      s.mids += static_cast<long long>(net.widths[l - 1]) * net.widths[l] +
                net.widths[l];
    }
    s.out = net.widths[n_layers - 1];
  }
  const Dequant dq = {dq_scale, dq_ln1mu, dq_inv_mu};

  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case kFloat32:
      return launch<float>(x, lanes, ld, n, n_evals, c, w1, c1, mids, out_a,
                           out_c, out, g, net, s, dq, smem, st);
    case kInt16:
      return launch<int16_t>(x, lanes, ld, n, n_evals, c, w1, c1, mids, out_a,
                             out_c, out, g, net, s, dq, smem, st);
    case kMulaw8:
      return launch<int8_t>(x, lanes, ld, n, n_evals, c, w1, c1, mids, out_a,
                            out_c, out, g, net, s, dq, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
