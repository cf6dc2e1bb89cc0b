// Fused syllable-detector kernel for Hopper (sm_90a), plain C interface:
// the precision tiers on the tensor cores and the pre-gathered frames input.
//
// Replaces the remaining entries of the Pallas TPU kernel of
// syllable_detector_tpu/kernels/fused_detector.py (_make_kernel, launched by
// _fused_call through pl.pallas_call):
//
//   * the fast / split precision tiers of the channel-grid layout
//     (_batch_core, fused_batch_offline_outputs with fast= or split=, K1c):
//     the band DFT GEMM and the first layer's conv filter-bank GEMM as 1, 3
//     or 4 bf16 products with fp32 accumulation;
//   * the pre-gathered frames input (fused_offline_outputs with
//     input_mode="frames", K1b): the same stages reading a [F, window]
//     float32 matrix of frames instead of a sample span.
//
// csrc/fused_detector.cu holds the full-fp32 raw-sample kernel (K1a, K1e,
// K1f) and is left as it was measured; this source repeats its staging and
// MLP stages and exchanges the two GEMM stages. The slabbed channel grid
// (_batch_core_slabbed, K1d) is the wrapper's loop over lane slabs of either
// kernel: a slab is a pointer offset here, not a copy.
//
// What a tier computes, as the TPU kernel does (split_dot there):
//   x_hi = bf16(x), x_lo = bf16(x - f32(x_hi)), round to nearest even; the
//   constants C and W1 are split the same way once per fold by the wrapper.
//   1 pass:   x_hi @ C_hi                                   (fast)
//   3 passes: x_hi @ C_hi + x_hi @ C_lo + x_lo @ C_hi       (split=True)
//   4 passes: ... + x_lo @ C_lo                             (split=4)
//   split="conv" keeps the DFT in fp32 (0 passes) and splits the conv GEMM.
// Each pass accumulates in fp32 in a fragment of its own and the passes are
// added in that order at the end. The l2 row sums of squares come from the
// fp32 scaled spectrogram, not from its bf16 halves. Hidden layers and the
// output affine stay fp32.
//
// Design: the grid is (tiles of evaluations, lanes), one CTA per tile of one
// lane. The wrapper picks the tile so that tile + T - 1 frames fill whole
// 16-row fragments (39 evaluations at the sample geometry: 48 frames). The
// CTA stages its sample span (or its rows of the frames matrix) in shared
// memory as fp32. For a bf16 DFT it materialises the [frames, window] tile
// as bf16 hi and lo in shared memory: frames overlap at stride hop (132,
// not a multiple of 8), so a wmma A fragment cannot be loaded from the span
// itself. The products are nvcuda::wmma m16n16k16 bf16 fragments with float
// accumulators; B fragments (C and W1g, padded with zeros to multiples of 16
// by the wrapper, in both halves) are loaded from device memory through L2.
// The conv GEMM is [frames, bins] @ [bins, T*h1] as in the TPU kernel, and
// evaluation e sums its T diagonal blocks conv[e+t, t*h1 : (t+1)*h1]. Padded
// bins never enter the spectrogram (|X| is taken per real bin), so log(0) of
// a padded column cannot reach a product. Pad rows read zeros and are never
// written out.
//
// What bounds it on the card: as the fp32 kernel, operations and not bytes
// (one hop of new audio per evaluation). The wmma tiles are small (3 x 4
// output fragments for the DFT) and their B operands come from L2, so this
// simple version is latency-bound; wgmma, TMA and a pipeline are later work.
//
// Built without --use_fast_math, like the fp32 kernel: silence gives NaN
// under l2normalize exactly as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kFrames = 8;    // frames one thread transforms in the fp32 DFT
constexpr int kPartials = 4;  // partial sums of the fp32 first layer
constexpr int kFrag = 16;     // wmma m = n = k
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
  int h1;            // width of the first layer
  int frames_input;  // 0: x holds samples; 1: x holds [F, window] frames
  int dft_passes;    // 0 (fp32), 1, 3 or 4 bf16 products
  int conv_passes;   // the same for the first layer's conv GEMM
};

struct NetMeta {
  int n_layers;
  int widths[kMaxLayers];
  int transfers[kMaxLayers];
};

// Elements between one lane's net operands and the next: 0 for a shared net.
struct LaneStrides {
  long long w1;
  long long w1g;  // the bf16 conv filter bank, hi and lo alike
  long long c1;
  long long mids;
  long long out;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Byte offsets of the CTA's shared-memory regions, each 32-byte aligned (a
// wmma fragment pointer must be).
struct Layout {
  int frames_pad;  // tile + T - 1, rounded up to whole fragments
  int wpad, npad;  // the DFT GEMM's K (window) and N (2 * bins), padded
  int bpad, ncpad; // the conv GEMM's K (bins) and N (T * h1), padded
  int row_stride;  // floats between two frames in the staged input
  int row_offset;  // floats before the first frame's first sample
  long long staged;  // staged floats
  long long samples, spec, rowsq, act_a, act_b;
  long long a_hi, a_lo, big, s_hi, s_lo, conv;
  long long bytes;
};

__host__ __device__ inline long long align32(long long v) { return (v + 31) / 32 * 32; }

__host__ __device__ inline Layout make_layout(const Geometry& g) {
  Layout l;
  l.frames_pad = round_up(g.tile + g.time_range - 1, kFrag);
  l.wpad = round_up(g.window, kFrag);
  l.npad = round_up(2 * g.bins, kFrag);
  l.bpad = round_up(g.bins, kFrag);
  l.ncpad = round_up(g.time_range * g.h1, kFrag);
  l.row_stride = g.frames_input ? g.window : g.hop;
  l.row_offset = g.frames_input ? 0 : g.gap;
  l.staged = g.frames_input
                 ? (long long)l.frames_pad * g.window
                 : (long long)(l.frames_pad - 1) * g.hop + g.gap + g.window;
  long long at = 0;
  l.samples = at; at = align32(at + l.staged * 4);
  l.spec = at;    at = align32(at + (long long)l.frames_pad * g.bins * 4);
  l.rowsq = at;   at = align32(at + (long long)l.frames_pad * 4);
  l.act_a = at;   at = align32(at + (long long)g.tile * g.max_width * 4);
  l.act_b = at;   at = align32(at + (long long)g.tile * g.max_width * 4);
  l.a_hi = l.a_lo = l.big = l.s_hi = l.s_lo = l.conv = 0;
  if (g.dft_passes) {
    l.a_hi = at; at = align32(at + (long long)l.frames_pad * l.wpad * 2);
    l.a_lo = at; at = align32(at + (long long)l.frames_pad * l.wpad * 2);
    l.big = at;  at = align32(at + (long long)l.frames_pad * l.npad * 4);
  }
  if (g.conv_passes) {
    l.s_hi = at; at = align32(at + (long long)l.frames_pad * l.bpad * 2);
    l.s_lo = at; at = align32(at + (long long)l.frames_pad * l.bpad * 2);
    l.conv = at; at = align32(at + (long long)l.frames_pad * l.ncpad * 4);
  }
  l.bytes = at;
  return l;
}

__device__ __forceinline__ float apply_transfer(float x, int code) {
  switch (code) {
    case kTanSig:
      return tanhf(x);
    case kLogSig:
      return 1.0f / (1.0f + expf(-x));
    case kSatLin:
      return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);  // NaN passes through
    default:
      return x;
  }
}

__device__ __forceinline__ void split_bf16(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

// out[rows, n_cols] (fp32, shared) = a[rows, k] @ b[k, n_cols] as `passes`
// bf16 products: a_hi/a_lo in shared memory (leading dimension lda), b_hi/
// b_lo in device memory (leading dimension ldb). All extents are multiples
// of 16. Each warp takes output fragments in turn.
__device__ void split_gemm(const bf16* a_hi, const bf16* a_lo, int lda,
                           const bf16* __restrict__ b_hi,
                           const bf16* __restrict__ b_lo, int ldb, float* out,
                           int rows, int k, int n_cols, int passes) {
  const int warp = threadIdx.x / 32;
  const int nt = n_cols / kFrag;
  const int tiles = rows / kFrag * nt;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int m = tile / nt;
    const int nn = tile - m * nt;
    wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> hh, hl, lh, ll;
    wmma::fill_fragment(hh, 0.0f);
    wmma::fill_fragment(hl, 0.0f);
    wmma::fill_fragment(lh, 0.0f);
    wmma::fill_fragment(ll, 0.0f);
    for (int kk = 0; kk < k; kk += kFrag) {
      wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> fa_hi, fa_lo;
      wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> fb_hi, fb_lo;
      wmma::load_matrix_sync(fa_hi, a_hi + (long long)m * kFrag * lda + kk, lda);
      wmma::load_matrix_sync(fb_hi, b_hi + (long long)kk * ldb + nn * kFrag, ldb);
      wmma::mma_sync(hh, fa_hi, fb_hi, hh);
      if (passes >= 3) {
        wmma::load_matrix_sync(fa_lo, a_lo + (long long)m * kFrag * lda + kk, lda);
        wmma::load_matrix_sync(fb_lo, b_lo + (long long)kk * ldb + nn * kFrag, ldb);
        wmma::mma_sync(hl, fa_hi, fb_lo, hl);
        wmma::mma_sync(lh, fa_lo, fb_hi, lh);
        if (passes == 4) wmma::mma_sync(ll, fa_lo, fb_lo, ll);
      }
    }
    if (passes >= 3) {
      for (int i = 0; i < hh.num_elements; ++i) {
        float acc = hh.x[i] + hl.x[i];
        acc += lh.x[i];
        if (passes == 4) acc += ll.x[i];
        hh.x[i] = acc;
      }
    }
    wmma::store_matrix_sync(out + (long long)m * kFrag * n_cols + nn * kFrag, hh,
                            n_cols, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads) fused_tiers_kernel(
    const float* __restrict__ x,  // [lanes, ld]: samples, or [F, window] frames
    long long ld, long long limit,  // floats of one lane that hold input
    long long n_evals,
    const float* __restrict__ c,     // [window, 2*bins] fp32, shared
    const bf16* __restrict__ c_hi,   // [wpad, npad], shared
    const bf16* __restrict__ c_lo,
    const float* __restrict__ w1,    // per net [T*bins, h1] fp32
    const bf16* __restrict__ w1g_hi, // per net [bpad, ncpad]
    const bf16* __restrict__ w1g_lo,
    const float* __restrict__ c1, const float* __restrict__ mids,
    const float* __restrict__ out_a, const float* __restrict__ out_c,
    float* __restrict__ out,         // [lanes, n_evals, outputs]
    Geometry g, NetMeta net, LaneStrides ls) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = make_layout(g);
  const long long lane = blockIdx.y;
  x += lane * ld;
  w1 += lane * ls.w1;
  w1g_hi += lane * ls.w1g;
  w1g_lo += lane * ls.w1g;
  c1 += lane * ls.c1;
  mids += lane * ls.mids;
  out_a += lane * ls.out;
  out_c += lane * ls.out;
  out += lane * n_evals * net.widths[net.n_layers - 1];
  const int b = g.bins;
  const int T = g.time_range;
  const int n_frames = g.tile + T - 1;
  const int frames_pad = l.frames_pad;
  const int mw = g.max_width;
  const int rs = l.row_stride;
  float* samples = reinterpret_cast<float*>(smem + l.samples);
  float* spec = reinterpret_cast<float*>(smem + l.spec);    // [frames_pad, bins]
  float* rowsq = reinterpret_cast<float*>(smem + l.rowsq);  // [frames_pad]
  float* act_a = reinterpret_cast<float*>(smem + l.act_a);  // [tile, max_width]
  float* act_b = reinterpret_cast<float*>(smem + l.act_b);

  const long long e0 = (long long)blockIdx.x * g.tile;
  const long long start = e0 * rs;

  // 1. this tile's sample span, or its rows of the frames matrix; reads past
  //    the input are zero
  for (long long i = threadIdx.x; i < l.staged; i += blockDim.x) {
    const long long j = start + i;
    samples[i] = j < limit ? x[j] : 0.0f;
  }
  __syncthreads();

  // 2. band DFT -> |X| -> scaling
  if (g.dft_passes == 0) {
    // fp32, as csrc/fused_detector.cu: bin k of kFrames consecutive frames
    const int two_b = 2 * b;
    const int groups = frames_pad / kFrames;
    for (int p = threadIdx.x; p < groups * b; p += blockDim.x) {
      const int grp = p / b;
      const int k = p - grp * b;
      const int f0 = grp * kFrames;
      const float* base = samples + (long long)f0 * rs + l.row_offset;
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
          const float v = base[r * rs + i];
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
  } else {
    // bf16 on the tensor cores: the [frames_pad, wpad] frame tile as hi and
    // lo halves, then one split GEMM against C (re | im, padded)
    bf16* a_hi = reinterpret_cast<bf16*>(smem + l.a_hi);
    bf16* a_lo = reinterpret_cast<bf16*>(smem + l.a_lo);
    float* big = reinterpret_cast<float*>(smem + l.big);  // [frames_pad, npad]
    for (int p = threadIdx.x; p < frames_pad * l.wpad; p += blockDim.x) {
      const int f = p / l.wpad;
      const int i = p - f * l.wpad;
      const float v =
          i < g.window ? samples[(long long)f * rs + l.row_offset + i] : 0.0f;
      split_bf16(v, a_hi + p, a_lo + p);
    }
    __syncthreads();
    split_gemm(a_hi, a_lo, l.wpad, c_hi, c_lo, l.npad, big, frames_pad, l.wpad,
               l.npad, g.dft_passes);
    __syncthreads();
    for (int p = threadIdx.x; p < frames_pad * b; p += blockDim.x) {
      const int f = p / b;
      const int k = p - f * b;
      const float re = big[f * l.npad + k];
      const float im = big[f * l.npad + b + k];
      float s = sqrtf(re * re + im * im);
      if (g.scaling == kLog) {
        s = logf(s);
      } else if (g.scaling == kDb) {
        s = kDbPerNeper * logf(s);
      }
      spec[p] = s;
    }
  }
  __syncthreads();

  // 3. per-frame row sums of squares of the fp32 spectrogram, and for a bf16
  //    conv GEMM its hi and lo halves (padded bins are zero in both)
  if (g.has_l2) {
    for (int f = threadIdx.x; f < n_frames; f += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < b; ++k) {
        const float v = spec[f * b + k];
        acc = fmaf(v, v, acc);
      }
      rowsq[f] = acc;
    }
  }
  if (g.conv_passes) {
    bf16* s_hi = reinterpret_cast<bf16*>(smem + l.s_hi);
    bf16* s_lo = reinterpret_cast<bf16*>(smem + l.s_lo);
    for (int p = threadIdx.x; p < frames_pad * l.bpad; p += blockDim.x) {
      const int f = p / l.bpad;
      const int k = p - f * l.bpad;
      split_bf16(k < b ? spec[f * b + k] : 0.0f, s_hi + p, s_lo + p);
    }
  }
  __syncthreads();

  // 4. first layer
  const int h1 = net.widths[0];
  if (g.conv_passes == 0) {
    // fp32, as csrc/fused_detector.cu: one dot product of length T*bins
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
  } else {
    // bf16: all T taps in one GEMM [frames, bins] @ [bins, T*h1]; tap t of
    // evaluation e is conv[e + t, t*h1 : (t+1)*h1]
    float* conv = reinterpret_cast<float*>(smem + l.conv);  // [frames_pad, ncpad]
    split_gemm(reinterpret_cast<bf16*>(smem + l.s_hi),
               reinterpret_cast<bf16*>(smem + l.s_lo), l.bpad, w1g_hi, w1g_lo,
               l.ncpad, conv, frames_pad, l.bpad, l.ncpad, g.conv_passes);
    __syncthreads();
    for (int p = threadIdx.x; p < g.tile * h1; p += blockDim.x) {
      const int e = p / h1;
      const int j = p - e * h1;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc += conv[(e + t) * l.ncpad + t * h1 + j];
      if (g.has_l2) {
        float norm = 0.0f;
        for (int t = 0; t < T; ++t) norm += rowsq[e + t];
        acc = acc / sqrtf(norm);
      }
      act_a[e * mw + j] = apply_transfer(acc + __ldg(c1 + j), net.transfers[0]);
    }
  }
  __syncthreads();

  // 5. hidden layers
  float* a_in = act_a;
  float* a_out = act_b;
  const float* wl = mids;
  for (int layer = 1; layer < net.n_layers; ++layer) {
    const int in_w = net.widths[layer - 1];
    const int out_w = net.widths[layer];
    const float* bl = wl + in_w * out_w;
    for (int p = threadIdx.x; p < g.tile * out_w; p += blockDim.x) {
      const int e = p / out_w;
      const int o = p - e * out_w;
      float z = 0.0f;
      for (int i = 0; i < in_w; ++i) {
        z = fmaf(a_in[e * mw + i], __ldg(wl + i * out_w + o), z);
      }
      a_out[e * mw + o] = apply_transfer(z + __ldg(bl + o), net.transfers[layer]);
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

bool valid_passes(int p) { return p == 0 || p == 1 || p == 3 || p == 4; }

Geometry make_geometry(int window, int hop, int gap, int bins, int time_range,
                       int scaling, int has_l2, int tile, int max_width, int h1,
                       int frames_input, int dft_passes, int conv_passes) {
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
  g.h1 = h1;
  g.frames_input = frames_input;
  g.dft_passes = dft_passes;
  g.conv_passes = conv_passes;
  return g;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that one CTA of the kernel needs.
long long sd_fused_tiers_smem_bytes(int window, int hop, int gap, int bins,
                                    int time_range, int tile, int max_width,
                                    int h1, int frames_input, int dft_passes,
                                    int conv_passes) {
  return make_layout(make_geometry(window, hop, gap, bins, time_range, 0, 0,
                                   tile, max_width, h1, frames_input,
                                   dft_passes, conv_passes))
      .bytes;
}

int sd_tiers_max_layers() { return kMaxLayers; }

const char* sd_tiers_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream` (device `device`) for `lanes` lanes, lane l
// at x + l * ld. With frames_input 0 a lane is `n` samples; with 1 it is a
// row-major [n, window] matrix of frames. c_hi/c_lo are C padded to
// [round_up(window, 16), round_up(2*bins, 16)] bf16; w1g_hi/w1g_lo are the
// conv filter bank w1g[k, t*h1 + j] = W1'[t, k, j] padded to
// [round_up(bins, 16), round_up(T*h1, 16)] bf16, one per net. They may be
// null when the matching pass count is 0. The other arguments are those of
// sd_fused_detector. Returns cudaGetLastError() after the launch.
int sd_fused_tiers(const float* x, int frames_input, int lanes, long long ld,
                   long long n, long long n_evals, const float* c,
                   const void* c_hi, const void* c_lo, const float* w1,
                   const void* w1g_hi, const void* w1g_lo, const float* c1,
                   const float* mids, const float* out_a, const float* out_c,
                   float* out, int per_lane_nets, int window, int hop, int gap,
                   int bins, int time_range, int scaling, int has_l2, int tile,
                   int dft_passes, int conv_passes, int n_layers,
                   const int* widths, const int* transfers, int device,
                   void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || tile < 1 || n_evals < 1 ||
      lanes < 1 || lanes > 65535 || n < 0 ||
      (tile + time_range - 1) % kFrag != 0 || !valid_passes(dft_passes) ||
      !valid_passes(conv_passes) || (dft_passes && (!c_hi || !c_lo)) ||
      (conv_passes && (!w1g_hi || !w1g_lo)) ||
      (n_evals + tile - 1) / tile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long limit = frames_input ? n * window : n;
  if (ld < limit) return static_cast<int>(cudaErrorInvalidValue);
  NetMeta net;
  net.n_layers = n_layers;
  int max_width = 0;
  for (int i = 0; i < kMaxLayers; ++i) {
    net.widths[i] = i < n_layers ? widths[i] : 0;
    net.transfers[i] = i < n_layers ? transfers[i] : 0;
    if (net.widths[i] > max_width) max_width = net.widths[i];
  }
  const Geometry g = make_geometry(window, hop, gap, bins, time_range, scaling,
                                   has_l2, tile, max_width, net.widths[0],
                                   frames_input, dft_passes, conv_passes);
  const Layout l = make_layout(g);

  LaneStrides s = {0, 0, 0, 0, 0};
  if (per_lane_nets) {
    s.w1 = static_cast<long long>(time_range) * bins * net.widths[0];
    s.w1g = static_cast<long long>(l.bpad) * l.ncpad;
    s.c1 = net.widths[0];
    for (int i = 1; i < n_layers; ++i) {
      s.mids += static_cast<long long>(net.widths[i - 1]) * net.widths[i] +
                net.widths[i];
    }
    s.out = net.widths[n_layers - 1];
  }

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // above 48 KB of dynamic shared memory a launch is refused unless the
  // kernel opts in first
  err = cudaFuncSetAttribute(fused_tiers_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n_evals + tile - 1) / tile),
                  static_cast<unsigned>(lanes));
  fused_tiers_kernel<<<grid, kThreads, static_cast<size_t>(l.bytes),
                       static_cast<cudaStream_t>(stream)>>>(
      x, ld, limit, n_evals, c, static_cast<const bf16*>(c_hi),
      static_cast<const bf16*>(c_lo), w1, static_cast<const bf16*>(w1g_hi),
      static_cast<const bf16*>(w1g_lo), c1, mids, out_a, out_c, out, g, net, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
