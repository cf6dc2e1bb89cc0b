// Fused syllable-detector kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of syllable_detector_tpu/kernels/
// fused_detector.py (_make_kernel, launched by _fused_call through
// pl.pallas_call) in its full-fp32 raw-sample forms: one stream
// (fused_offline_outputs, K1a), a [lanes, n] batch of streams with one
// shared net or one net per lane (fused_flat_batch_offline_outputs /
// _flat_core, K1e), slabs of such lanes (_batch_core_slabbed, K1d), and that
// batch read from an int16 or 8-bit mu-law wire and dequantised on the card
// (fused_batch_program, K1f). For every evaluation e of a lane it computes,
// without writing any intermediate to device memory:
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
// What bounds it on the card: the band DFT is ~15k MACs per frame (2 * bins
// * window at the sample geometry) against one hop of new audio (528 bytes
// as float32, 264 as int16), so it is compute- and not bandwidth-bound, and
// on the CUDA cores each of those MACs costs a load as well: with one
// thread per bin the stage took 3/4 of a CTA's cycles waiting for C.
//
// What the design does about it. The band DFT runs on the tensor cores as
// a GEMM [frames, window] @ [window, 2*bins] in wgmma m64n64k8 TF32 tiles,
// kept to fp32 accuracy by splitting both operands into two TF32 halves
// (hi = tf32(v), lo = tf32(v - hi), round to nearest) and summing three
// products per k-step, small terms first: a_lo*c_hi + a_hi*c_lo +
// a_hi*c_hi, accumulated in fp32. This is what Precision.HIGHEST does on
// the TPU with bf16 passes.
//   * A comes from registers. A thread loads its fragment element by
//     element straight from the staged sample span: frame f, column k is
//     span[f*hop + gap + k], so the overlapping frames are never
//     materialised. At hop = 132 = 4 (mod 32) a fragment's 32 addresses
//     fall on 32 banks; another hop only costs bank conflicts. Samples are
//     split into halves as they are loaded. The fragments of the next row
//     block are loaded while the tensor cores work on this one.
//   * B comes from shared memory. C is split once on the host (fold time),
//     its columns permuted so that 8-column tile 2j holds re of bins
//     8j..8j+7 and tile 2j+1 their im (a thread then holds re and im of the
//     same bin and frame), padded with zeros to whole chunks of 64 columns
//     and whole blocks of kBlockRows rows, and stored in the very order the
//     tensor cores read a k-step from shared memory (core matrices of 8
//     columns x 4 rows), so a row block is one contiguous cp.async copy.
//     The CTA streams the blocks through kStages stages, one barrier per
//     block. One block serves all the CTA's frames.
//   * A warpgroup owns 64 frames x 64 columns (one wgmma tile, 32
//     accumulators a thread). A CTA has one warpgroup per such unit, at
//     most 2; more units run in rounds. (With mma.sync m16n8k8, 24
//     instructions a warp and k-step, the stage took about twice as long:
//     a warp started one about every 33 cycles.)
//   * A CTA transforms `frames` frames (a multiple of 64, chosen by the
//     wrapper from the launch shape) for frames - T + 1 evaluations: 128
//     frames for 119 evaluations is 1.08 transforms per evaluation. An
//     evaluation's sums do not depend on its place in a tile, on the tile
//     size, or on the lane slab or shard it is launched in.
// The rest (|X|, scaling, row sums, first layer, l2, transfers, hidden
// layers, output affine) is fp32 on the CUDA cores. The first layer's
// weights are copied into the freed stages of C; a thread takes a stretch of
// the dot product for 4 evaluations x 4 hidden units, and the stretches are
// summed by shuffles. Geometry, layer widths and transfer codes are runtime
// values, so one build serves every net the fused path accepts.
//
// Built without --use_fast_math on purpose: tanhf, expf, expm1f, logf,
// sqrtf and the division keep their IEEE behaviour, including the NaN on
// silence. The dequantising products are __fmul_rn, so they are never
// contracted into an FMA: the int16 wire's samples are bit-exact with the
// JAX program's; the band DFT after them agrees to rounding (~1e-6).

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxGroups = kMaxWarps / 4;  // warpgroups of a CTA
constexpr int kMaxLayers = 8;
constexpr int kMaxDevices = 64;
// Rows of C per shared-memory stage, and stages in flight.
constexpr int kBlockRows = 16;
constexpr int kStages = 3;
// Samples a thread has in flight while it stages the span.
constexpr int kStageUnroll = 8;
// A warpgroup's unit is one wgmma tile: kUnitFrames frames x kUnitCols
// columns of C (kUnitCols / 16 bin groups of kGroupBins bins, re and im).
constexpr int kUnitFrames = 64;
constexpr int kUnitCols = 64;
constexpr int kGroupBins = 8;
// Floats of one k-step (8 rows of C) of one unit of one half: 8 x 64.
constexpr int kStepFloats = 8 * kUnitCols;
// Stretches the first layer's dot product is cut into (a power of two, at
// most 32: they are summed across neighbouring lanes).
constexpr int kSplits = 8;
// Neighbouring evaluations a thread takes in the first layer.
constexpr int kL1Evals = 4;
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
  int frames;  // frames a CTA transforms, a multiple of kUnitFrames
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

// Layout of the padded, split C: see the note at sd_fused_detector_c_blocks.
__host__ __device__ inline int bin_groups(const Geometry& g) {
  return (g.bins + kGroupBins - 1) / kGroupBins;
}
// Column chunks of kUnitCols that hold all bin groups.
__host__ __device__ inline int col_chunks(const Geometry& g) {
  return (2 * kGroupBins * bin_groups(g) + kUnitCols - 1) / kUnitCols;
}
__host__ __device__ inline int rows_pad(const Geometry& g) {
  return (g.window + kBlockRows - 1) / kBlockRows * kBlockRows;
}
// Floats of one staged row block: both halves, every k-step and chunk.
__host__ __device__ inline int block_floats(const Geometry& g) {
  return 2 * (kBlockRows / 8) * col_chunks(g) * kStepFloats;
}
// Units of a CTA, one warpgroup each.
__host__ __device__ inline int n_units(const Geometry& g) {
  return g.frames / kUnitFrames * col_chunks(g);
}
__host__ __device__ inline int n_groups(const Geometry& g) {
  const int u = n_units(g);
  return u < kMaxGroups ? u : kMaxGroups;
}

// The staged span, rounded up to whole 16-byte chunks.
__host__ __device__ inline long long span_floats(const Geometry& g) {
  const long long span = (long long)(g.frames - 1) * g.hop + g.gap + g.window;
  return (span + 3) / 4 * 4;
}

__host__ __device__ inline long long smem_floats(const Geometry& g) {
  const long long tile = g.frames - g.time_range + 1;
  return span_floats(g) + (long long)kStages * block_floats(g) +
         (long long)g.frames * g.bins + g.frames + 2 * tile * g.max_width;
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

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// The shared-memory descriptor of one k-step of B for wgmma: a [64, 8]
// (n, k) tile, k-major, no swizzle, as core matrices of 8 n x 4 k (128
// contiguous bytes, 16 per n). The two core matrices of an n block lie side
// by side (128 bytes apart along k), the n blocks 256 bytes apart.
__device__ __forceinline__ uint64_t b_descriptor(const float* tile) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(tile));
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d += a @ b for one warpgroup: a [64, 8] TF32 from registers (this warp's
// 16 rows in the m16n8k8 fragment layout), b [8, 64] TF32 from shared
// memory, d [64, 64] fp32 in registers (8 column tiles of the m16n8
// accumulator layout).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Cycle counts per stage, summed over CTAs by their thread 0 when a profile
// buffer is set (see sd_fused_detector_set_profile).
__device__ __forceinline__ void stamp(unsigned long long* prof, int slot,
                                      long long& t) {
  if (prof != nullptr && threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(prof + slot, static_cast<unsigned long long>(now - t));
    t = now;
  }
}

template <typename Sample>
__global__ void __launch_bounds__(kMaxWarps * 32) fused_detector_kernel(
    const Sample* __restrict__ x,         // [lanes, ld]: lane samples on the wire
    long long ld, long long n, long long n_evals,
    const float* __restrict__ cs,    // C's TF32 halves in the kernel's tiles
    const float* __restrict__ w1,    // per net [T*bins, h1]
    const float* __restrict__ c1,    // per net [h1]
    const float* __restrict__ mids,  // per net, per hidden layer: W [in, out], b [out]
    const float* __restrict__ out_a, const float* __restrict__ out_c,
    float* __restrict__ out,         // [lanes, n_evals, outputs]
    Geometry g, NetMeta net, LaneStrides ls, Dequant dq,
    unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
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
  const int tile = g.frames - T + 1;
  const int mw = g.max_width;
  const long long span = span_floats(g);
  const int kp = rows_pad(g);
  const int chunks = col_chunks(g);
  const int block = block_floats(g);
  float* samples = smem;
  float* stages = samples + span;  // [kStages][block]
  float* spec = stages + kStages * block;  // [frames, bins]
  float* rowsq = spec + g.frames * b;                        // [frames]
  float* act_a = rowsq + g.frames;                           // [tile, max_width]
  float* act_b = act_a + tile * mw;                          // [tile, max_width]

  const long long e0 = (long long)blockIdx.x * tile;
  const long long start = e0 * g.hop;
  long long t_prof = prof != nullptr ? clock64() : 0;

  // Row block kb of both halves of C into stage kb % kStages.
  // Row block kb into stage kb % kStages: one contiguous piece of `cs`.
  auto prefetch = [&](int kb) {
    float* dst = stages + (kb % kStages) * block;
    const float* src = cs + (long long)kb * block;
    for (int i = 4 * threadIdx.x; i < block; i += 4 * blockDim.x) {
      cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  const int n_blocks = kp / kBlockRows;
  // kStages - 1 blocks in flight; a group is committed per block even when
  // there is none left, so that the wait counts stay the same
  auto prefetch_or_skip = [&](int kb) {
    if (kb < n_blocks) {
      prefetch(kb);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int kb = 0; kb < kStages - 1; ++kb) prefetch_or_skip(kb);

  // 1. this tile's sample span, dequantised; reads past the stream are
  //    zero. Where the lane's samples are 16-byte aligned they are read 16
  //    bytes at a time, kStageUnroll loads in flight per thread.
  {
    // The mu-law expansion costs an expm1f a sample: its 256 values are
    // computed once, by the same expression, into the stage of C that no
    // copy is in flight to, and looked up from there.
    const float* lut = stages + (kStages - 1) * block;
    if (sizeof(Sample) == 1) {
      float* table = stages + (kStages - 1) * block;
      for (int i = threadIdx.x; i < 256; i += blockDim.x) {
        table[i] = dequant(static_cast<Sample>(static_cast<int8_t>(i)), dq);
      }
      __syncthreads();
    }
    auto expand = [&](Sample v) {
      return sizeof(Sample) == 1 ? lut[static_cast<uint8_t>(v)] : dequant(v, dq);
    };
    constexpr int kVec = 16 / sizeof(Sample);  // samples per 16-byte load
    const Sample* xs = x + start;
    const long long left = n - start;  // samples of the stream from `start`
    const long long avail = left < 0 ? 0 : (left < span ? left : span);
    const bool aligned = (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
    const int n_vec = aligned ? static_cast<int>(avail / kVec) : 0;
    const uint4* xv = reinterpret_cast<const uint4*>(xs);
    const int step = blockDim.x * kStageUnroll;
    for (int v0 = threadIdx.x; v0 < n_vec; v0 += step) {
      uint4 raw[kStageUnroll];
#pragma unroll
      for (int q = 0; q < kStageUnroll; ++q) {
        const int v = v0 + q * blockDim.x;
        if (v < n_vec) raw[q] = __ldcs(xv + v);
      }
#pragma unroll
      for (int q = 0; q < kStageUnroll; ++q) {
        const int v = v0 + q * blockDim.x;
        if (v < n_vec) {
          const Sample* e = reinterpret_cast<const Sample*>(&raw[q]);
          float4* dst = reinterpret_cast<float4*>(samples + (long long)v * kVec);
#pragma unroll
          for (int w = 0; w < kVec / 4; ++w) {
            dst[w] = make_float4(expand(e[4 * w]), expand(e[4 * w + 1]),
                                 expand(e[4 * w + 2]), expand(e[4 * w + 3]));
          }
        }
      }
    }
    for (long long i = (long long)n_vec * kVec + threadIdx.x; i < span; i += blockDim.x) {
      samples[i] = i < left ? expand(xs[i]) : 0.0f;
    }
  }
  stamp(prof, 0, t_prof);

  // 2. band DFT on the tensor cores -> |X| -> scaling
  const int lane_id = threadIdx.x & 31;
  const int gid = lane_id >> 2;  // the fragment's row
  const int tig = lane_id & 3;   // the fragment's k (A) or column pair (D)
  const int group = threadIdx.x >> 7;           // this thread's warpgroup
  const int groups_n = blockDim.x >> 7;
  const int wrow = ((threadIdx.x >> 5) & 3) * 16;  // this warp's rows of the tile
  const int units = n_units(g);
  for (int u0 = 0; u0 < units; u0 += groups_n) {
    const int u = u0 + group;
    const bool active = u < units;
    const int mg = u / chunks;        // which 64 frames
    const int ch = u - mg * chunks;   // which 64 columns
    // rows gid and gid + 8 of this warp's 16 frames, at column tig
    const float* arow0 =
        samples + (long long)(mg * kUnitFrames + wrow + gid) * g.hop + g.gap + tig;
    const float* arow1 = arow0 + 8 * g.hop;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
    // The A fragments of one row block, split into halves: for each k-step
    // (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4), zero
    // past the window.
    constexpr int kSteps = kBlockRows / 8;
    auto load_a = [&](int kb, uint32_t (&hi)[kSteps][4], uint32_t (&lo)[kSteps][4]) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int k0 = kb * kBlockRows + ks * 8;
        const bool in0 = k0 + tig < g.window;
        const bool in1 = k0 + tig + 4 < g.window;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = q < 2 ? in0 : in1;
          const float v = in ? ((q & 1) ? arow1 : arow0)[k0 + (q >> 1) * 4] : 0.0f;
          hi[ks][q] = to_tf32(v);
          lo[ks][q] = to_tf32(v - __uint_as_float(hi[ks][q]));
        }
      }
    };
    if (u0 > 0) {
#pragma unroll
      for (int kb = 0; kb < kStages - 1; ++kb) prefetch_or_skip(kb);
    } else {
      __syncthreads();  // the span is staged
    }
    uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
    if (active) load_a(0, a_hi, a_lo);
    for (int kb = 0; kb < n_blocks; ++kb) {
      cp_async_wait<kStages - 2>();
      // block kb has landed, and every warp is done with block kb - 1, whose
      // stage the next prefetch overwrites
      __syncthreads();
      prefetch_or_skip(kb + kStages - 1);
      stamp(prof, 4, t_prof);
      if (active) {
        const float* cb = stages + (kb % kStages) * block;
        // three products per k-step, small terms first
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const float* step = cb + (ks * chunks + ch) * kStepFloats;
          const uint64_t b_hi = b_descriptor(step);
          const uint64_t b_lo = b_descriptor(step + block / 2);
          wgmma_tf32(acc, a_lo[ks], b_hi);
          wgmma_tf32(acc, a_hi[ks], b_lo);
          wgmma_tf32(acc, a_hi[ks], b_hi);
        }
        wgmma_commit();
        // the next block's fragments are loaded while the tensor cores run;
        // these ones are read by them until the wait, so they stay where
        // they are until then
        uint32_t n_hi[kSteps][4], n_lo[kSteps][4];
        const bool more = kb + 1 < n_blocks;
        if (more) load_a(kb + 1, n_hi, n_lo);
        wgmma_wait();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            asm volatile("" ::"r"(a_hi[ks][q]), "r"(a_lo[ks][q]));
            if (more) {
              a_hi[ks][q] = n_hi[ks][q];
              a_lo[ks][q] = n_lo[ks][q];
            }
          }
        }
      }
      stamp(prof, 5, t_prof);
    }
    __syncthreads();  // before the next round's prefetch overwrites a stage
    if (active) {
      // column tile 2j holds re and tile 2j + 1 im of bin group 4*ch + j;
      // this thread has columns 2*tig, 2*tig + 1 of rows gid and gid + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = (4 * ch + j) * kGroupBins + 2 * tig + (q & 1);
          const int f = mg * kUnitFrames + wrow + gid + (q >> 1) * 8;
          const float re = acc[8 * j + q];
          const float im = acc[8 * j + 4 + q];
          float s = sqrtf(re * re + im * im);
          if (g.scaling == kLog) {
            s = logf(s);
          } else if (g.scaling == kDb) {
            s = kDbPerNeper * logf(s);
          }
          if (k < b) spec[f * b + k] = s;
        }
      }
    }
  }
  // The stages of C are free now: the first layer's weights go there, when
  // they fit, while the row sums are taken (L1 is small beside this much
  // shared memory, and the sample loads stream through it).
  const int h1 = net.widths[0];
  const int n_feat = T * b;
  const bool w1_vec = (h1 & 3) == 0 && (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  const bool w1_staged = w1_vec && n_feat * h1 <= kStages * block;
  if (w1_staged) {
    for (int i = 4 * threadIdx.x; i < n_feat * h1; i += 4 * blockDim.x) {
      cp_async16(stages + i, w1 + i);
    }
    cp_async_commit();
  }
  __syncthreads();
  stamp(prof, 1, t_prof);

  // 3. per-frame row sums of squares, for the sliding l2 norm
  if (g.has_l2) {
    for (int f = threadIdx.x; f < g.frames; f += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < b; ++k) {
        const float v = spec[f * b + k];
        acc = fmaf(v, v, acc);
      }
      rowsq[f] = acc;
    }
  }
  __syncthreads();
  // the sliding norm of each evaluation, kept in the second activation
  // buffer until the hidden layers need it
  float* norms = act_b;
  if (g.has_l2) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      float norm = 0.0f;
      for (int t = 0; t < T; ++t) norm += rowsq[e + t];
      norms[e] = sqrtf(norm);
    }
  }
  if (w1_staged) cp_async_wait<0>();
  __syncthreads();

  // 4. first layer: the feature vector of evaluation e is spectrogram rows
  //    e .. e+T-1, contiguous in shared memory, so the T-tap convolution is
  //    one dot product of length T*bins per hidden unit. A thread takes one
  //    of kSplits stretches of that dot product for kL1Evals neighbouring
  //    evaluations x 4 neighbouring hidden units: a row of weights (one
  //    16-byte load where h1 is a multiple of 4) feeds kL1Evals evaluations
  //    and a feature 4 hidden units. The stretches are neighbouring lanes
  //    and are summed by shuffles, in the same order for every evaluation.
  const int quads = (h1 + 3) / 4;
  const int e_groups = (tile + kL1Evals - 1) / kL1Evals;
  const int stretch = (n_feat + kSplits - 1) / kSplits;
  const float* w1s = w1_staged ? stages : w1;
  const int items = e_groups * quads * kSplits;
  for (int p0 = 0; p0 < items; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool valid = p < items;
    const int sp = p % kSplits;
    const int rest = p / kSplits;
    const int eg = valid ? rest / quads : 0;
    const int j0 = 4 * (rest - (rest / quads) * quads);
    const int d0 = sp * stretch;
    const int d1 = valid ? min(d0 + stretch, n_feat) : d0;
    // an evaluation past the tile repeats the last one and is not stored
    const float* feat[kL1Evals];
#pragma unroll
    for (int i = 0; i < kL1Evals; ++i) {
      feat[i] = spec + min(eg * kL1Evals + i, tile - 1) * b;
    }
    float part[kL1Evals][4];
#pragma unroll
    for (int i = 0; i < kL1Evals; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
    }
#pragma unroll 4
    for (int d = d0; d < d1; ++d) {
      float w[4];
      if (w1_vec) {
        const float4 wv = *reinterpret_cast<const float4*>(w1s + d * h1 + j0);
        w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = j0 + c < h1 ? __ldg(w1 + d * h1 + j0 + c) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kL1Evals; ++i) {
        const float f = feat[i][d];
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = fmaf(f, w[c], part[i][c]);
      }
    }
    // every lane of a group of kSplits gets all the sums; lane sp then
    // finishes sums sp, sp + kSplits, ... (chosen by selects, so that the
    // lanes of a warp stay together through the division and the transfer)
    float total[kL1Evals * 4];
#pragma unroll
    for (int q = 0; q < kL1Evals * 4; ++q) {
      float acc = part[q >> 2][q & 3];
#pragma unroll
      for (int m = 1; m < kSplits; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      total[q] = acc;
    }
#pragma unroll
    for (int r = 0; r < kL1Evals * 4 / kSplits; ++r) {
      const int idx = sp + kSplits * r;
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kL1Evals * 4; ++q) acc = q == idx ? total[q] : acc;
      const int e = eg * kL1Evals + (idx >> 2);
      const int j = j0 + (idx & 3);
      if (valid && e < tile && j < h1) {
        if (g.has_l2) acc = acc / norms[e];
        act_a[e * mw + j] = apply_transfer(acc + __ldg(c1 + j), net.transfers[0]);
      }
    }
  }
  __syncthreads();
  stamp(prof, 2, t_prof);

  // 5. hidden layers
  float* a_in = act_a;
  float* a_out = act_b;
  const float* wl = mids;
  for (int l = 1; l < net.n_layers; ++l) {
    const int in_w = net.widths[l - 1];
    const int out_w = net.widths[l];
    const float* bl = wl + in_w * out_w;
    for (int p = threadIdx.x; p < tile * out_w; p += blockDim.x) {
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
  for (int p = threadIdx.x; p < tile * n_out; p += blockDim.x) {
    const int e = p / n_out;
    const int o = p - e * n_out;
    const long long ev = e0 + e;
    if (ev < n_evals) {
      out[ev * n_out + o] = a_in[e * mw + o] * __ldg(out_a + o) + __ldg(out_c + o);
    }
  }
  stamp(prof, 3, t_prof);
}

// Device buffer of 8 cycle counters, or null: see stamp().
unsigned long long* g_profile = nullptr;

// Above 48 KB of dynamic shared memory a launch is refused unless the
// kernel opts in first. The opt-in is a maximum, so it is raised once per
// kernel instantiation, device and size, not on every launch.
template <typename Sample>
cudaError_t opt_in(int device, size_t smem) {
  static std::mutex mutex;
  static size_t granted[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mutex);
  if (device >= 0 && device < kMaxDevices && smem <= granted[device]) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      fused_detector_kernel<Sample>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    granted[device] = smem;
  }
  return err;
}

template <typename Sample>
int launch(const void* x, int lanes, long long ld, long long n,
           long long n_evals, const float* cs, const float* w1,
           const float* c1, const float* mids, const float* out_a,
           const float* out_c, float* out, const Geometry& g,
           const NetMeta& net, const LaneStrides& ls, const Dequant& dq,
           size_t smem, int device, cudaStream_t stream) {
  const cudaError_t err = opt_in<Sample>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = g.frames - g.time_range + 1;
  const dim3 grid(static_cast<unsigned>((n_evals + tile - 1) / tile),
                  static_cast<unsigned>(lanes));
  fused_detector_kernel<Sample><<<grid, 128 * n_groups(g), smem, stream>>>(
      static_cast<const Sample*>(x), ld, n, n_evals, cs, w1, c1, mids, out_a,
      out_c, out, g, net, ls, dq, g_profile);
  return static_cast<int>(cudaGetLastError());
}

Geometry make_geometry(int window, int hop, int gap, int bins, int time_range,
                       int scaling, int has_l2, int frames, int max_width) {
  Geometry g;
  g.window = window;
  g.hop = hop;
  g.gap = gap;
  g.bins = bins;
  g.time_range = time_range;
  g.scaling = scaling;
  g.has_l2 = has_l2;
  g.frames = frames;
  g.max_width = max_width;
  return g;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, that one CTA of the kernel needs when it
// transforms `frames` frames.
long long sd_fused_detector_smem_bytes(int window, int hop, int gap, int bins,
                                       int time_range, int frames,
                                       int max_width) {
  const Geometry g = make_geometry(window, hop, gap, bins, time_range, 0, 0,
                                   frames, max_width);
  return smem_floats(g) * (long long)sizeof(float);
}

int sd_max_layers() { return kMaxLayers; }


// Shape of the split C the kernel reads: [blocks, 2, steps, chunks, 8, 2, 8,
// 4] floats = blocks of kBlockRows rows x (hi, lo) x k-steps of 8 rows x
// chunks of 64 columns x blocks of 8 columns x halves of a k-step x column
// x row: element (row r, column c) of half h lies at block r / 16, h, step
// (r % 16) / 8, chunk c / 64, (c % 64) / 8, (r % 8) / 4, c % 8, r % 4.
int sd_fused_detector_c_blocks(int window) {
  return (window + kBlockRows - 1) / kBlockRows;
}
int sd_fused_detector_c_chunks(int bins) {
  return (2 * kGroupBins * ((bins + kGroupBins - 1) / kGroupBins) + kUnitCols - 1) /
         kUnitCols;
}

const char* sd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Device buffer of 8 unsigned 64-bit counters that every later launch adds
// its CTAs' clock64() cycles to, or null to stop: [0] staging, [1] the band
// DFT's epilogue, [2] first layer, [3] the rest, [4] waiting for a block of
// C, [5] the mma steps on it ([1] + [4] + [5] is the band DFT). For
// measurements only.
void sd_fused_detector_set_profile(void* counters) {
  g_profile = static_cast<unsigned long long*>(counters);
}

// Launches the kernel on `stream` (device `device`) for `lanes` streams of
// `n` samples each, lane l at x + l * ld, as wire type `wire` (a Wire
// code). All pointers are device pointers except `widths` and `transfers`,
// host arrays of n_layers ints. `cs` is C padded with zeros, its columns in
// tiles of 8 (re of bins 8j..8j+7, then their im), split into TF32 halves
// and laid out as sd_fused_detector_c_blocks / _c_chunks describe. `frames` is the number
// of frames one CTA transforms, a multiple of 64 above time_range - 1; it
// serves frames - time_range + 1 evaluations. `per_lane_nets` is 0 when
// every lane shares one net and 1 when the net operands hold one net per
// lane, stacked. Returns cudaGetLastError() after the launch: 0 when the
// launch was taken.
int sd_fused_detector(const void* x, int wire, int lanes, long long ld,
                      long long n, long long n_evals, const float* cs,
                      const float* w1, const float* c1, const float* mids,
                      const float* out_a, const float* out_c, float* out,
                      int per_lane_nets, int window, int hop, int gap,
                      int bins, int time_range, int scaling, int has_l2,
                      int frames, int n_layers, const int* widths,
                      const int* transfers, float dq_scale, float dq_ln1mu,
                      float dq_inv_mu, int device, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_evals < 1 || lanes < 1 ||
      lanes > 65535 || n < 0 || ld < n || window < 1 || hop < 1 || gap < 0 ||
      bins < 1 || time_range < 1 || frames < kUnitFrames ||
      frames % kUnitFrames != 0 || frames < time_range) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile = frames - time_range + 1;
  if ((n_evals + tile - 1) / tile > 0x7fffffffLL) {
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
                                   scaling, has_l2, frames, max_width);
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
      return launch<float>(x, lanes, ld, n, n_evals, cs, w1, c1, mids, out_a,
                           out_c, out, g, net, s, dq, smem, device, st);
    case kInt16:
      return launch<int16_t>(x, lanes, ld, n, n_evals, cs, w1, c1, mids, out_a,
                             out_c, out, g, net, s, dq, smem, device, st);
    case kMulaw8:
      return launch<int8_t>(x, lanes, ld, n, n_evals, cs, w1, c1, mids, out_a,
                            out_c, out, g, net, s, dq, smem, device, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
