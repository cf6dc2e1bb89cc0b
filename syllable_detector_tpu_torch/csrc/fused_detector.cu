// Fused syllable-detector kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of syllable_detector_tpu/kernels/
// fused_detector.py (_make_kernel, launched by _fused_call through
// pl.pallas_call) in every form the JAX package launches it: one stream
// (fused_offline_outputs, K1a), a [lanes, n] batch of streams with one
// shared net or one net per lane (fused_flat_batch_offline_outputs /
// _flat_core, K1e), slabs of such lanes (_batch_core_slabbed, K1d), that
// batch read from an int16 or 8-bit mu-law wire and dequantised on the card
// (fused_batch_program, K1f), the pre-gathered frames input
// (input_mode="frames", K1b) and the precision tiers (fast / split,
// _batch_core's split_dot, K1c). For every evaluation e of a lane it
// computes, without writing any intermediate to device memory:
//
//   frames  x[e*hop + gap + i], i < window      (hop-strided, zero past n),
//           or row e of a [F, window] frames matrix
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
// a GEMM [frames, window] @ [window, 2*bins], A from registers, B from
// shared memory, in one of two arithmetics chosen at compile time:
//   * full fp32 (kDftPasses = 0): wgmma m64n64k8 TF32 tiles, kept to fp32
//     accuracy by splitting both operands into two TF32 halves (hi =
//     tf32(v), lo = tf32(v - hi), round to nearest) and summing three
//     products per k-step, small terms first: a_lo*c_hi + a_hi*c_lo +
//     a_hi*c_hi, accumulated in fp32. This is what Precision.HIGHEST does on
//     the TPU with bf16 passes.
//   * a precision tier (kDftPasses = 1, 3 or 4): wgmma m64n64k16 bf16 tiles
//     of the JAX kernel's split_dot halves, hi = bf16(v), lo = bf16(v - hi),
//     round to nearest even: 1 pass hi*hi (fast), 3 passes hi*hi + hi*lo +
//     lo*hi (split=True), 4 with lo*lo (split=4). All passes go into ONE
//     fp32 accumulator, small terms first within each k-step (lo*lo,
//     lo*hi, hi*lo, hi*hi), where split_dot sums one product per pass and
//     adds the passes; the two orders differ by fp32 rounding only, far
//     inside the tiers' tolerances. Never TF32.
// Both arithmetics share the structure:
//   * A comes from registers. A thread loads its fragment element by
//     element straight from the staged sample span: frame f, column k is
//     span[f*hop + gap + k], so the overlapping frames are never
//     materialised (frames input: row f of the staged rows, at a padded
//     stride of window rounded up to 32, plus 4). At a row stride of 4 (mod
//     32) a fragment's 32 addresses fall on 32 banks; another stride only
//     costs bank conflicts. Samples are split into halves as they are
//     loaded. The fragments of the next row block are loaded while the
//     tensor cores work on this one. A thread loads the same columns for a
//     bf16 k-step of 16 as for two TF32 k-steps of 8 (k, k+4, k+8, k+12):
//     the bf16 fragment's k order is permuted to match, and C's rows with
//     it (the fold's tile_dft_matrix_bf16), which leaves the sum unchanged.
//   * B comes from shared memory. C is split once on the host (fold time),
//     its columns permuted so that 8-column tile 2j holds re of bins
//     8j..8j+7 and tile 2j+1 their im (a thread then holds re and im of the
//     same bin and frame), padded with zeros to whole chunks of 64 columns
//     and whole row blocks, and stored in the very order the tensor cores
//     read a k-step from shared memory (core matrices of 8 columns x 16
//     bytes), so a row block is one contiguous cp.async copy. A row block is
//     16 rows of TF32 or 32 rows of bf16 (the same bytes), so a bf16 tier
//     has half the blocks: 8 at window 256. The CTA streams the blocks
//     through kStages stages, one barrier per block. One block serves all
//     the CTA's frames. The fast tier copies only the hi halves.
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
// The first layer is fp32 on the CUDA cores (kConvPasses = 0) or, under a
// tier, the JAX kernel's conv filter-bank GEMM [frames, bins] @ [bins,
// T*h1] in the tier's bf16 passes on the tensor cores (wgmma m64n64k16 over
// all T taps at once; A from the fp32 spectrogram, split as loaded; B the
// bank w1g[k, t*h1 + j] = W1'[t, k, j], tiled by the fold's
// tile_conv_bank_bf16 and copied into the freed stages of C), its product
// written over the span, which is dead by then; evaluation e then sums its
// T diagonal blocks conv[e+t, t*h1 : (t+1)*h1]. Padded bins never enter the
// spectrogram (|X| is taken per real bin), so log(0) of a padded column
// cannot reach a product. The row sums of squares for l2 always come from
// the fp32 spectrogram. The rest (|X|, scaling, l2, transfers, hidden
// layers, output affine) is fp32 on the CUDA cores. In the fp32 first
// layer the weights are copied into the freed stages of C; a thread takes a
// stretch of the dot product for 4 evaluations x 4 hidden units, and the
// stretches are summed by shuffles. Geometry, layer widths and transfer
// codes are runtime values (the widths and codes a device table, so a net
// may have any depth), so one build serves every net the fused path
// accepts; the arithmetic, the wire and the input form are template
// arguments, so the full-fp32 forms carry no code of the tiers.
//
// Where T*h1 is wide (the wrapper decides, from the spec), the fp32 first
// layer runs as the tiers' does, on the tensor cores: the conv filter-bank
// GEMM in the DFT's arithmetic (three TF32 products of split operands,
// conv_passes = kConvTf32), chunk by chunk (see chunked first layer below).
//
// Three shared-memory layouts, the template argument kLayout, chosen per
// launch by the wrapper (cta_choice in kernels/fused_detector.py) and
// named by the sign of col_group. The resident layout (col_group 0),
// above, holds a CTA's whole working set: the sample span ((frames - 1) *
// hop + gap + window), every column chunk of C in each stage and, under a
// bf16 first layer, its whole product [frames, T*h1] and filter bank. These
// grow with the hop and window, the bins and T*h1; at fft 512-1024 or a
// wide first layer they pass the 227 KB a CTA may take, mostly through C's
// stages and the spectrogram, seldom through the span. So:
//   * the span layout (col_group -n) keeps the span (or the frame rows)
//     resident and reads A from it as the resident layout does, and
//     streams C by column chunk: a pass over k covers n chunks, the ones a
//     round of the CTA's two warpgroups takes (a pass's units go chunk by
//     chunk, a warpgroup taking two chunks as two chains of products: two
//     chunks at 128 frames, four at 64);
//   * the streamed layout (col_group n; see ring_floats), for spans that do
//     not fit either (long hops, 96 kHz at fft 1024 with 128 frames), also
//     stages A by k-block: each round stages rows kb*kRows .. +kRows of
//     only the 64-frame groups its units use, into kAStages buffers taken
//     in turn, all by cp.async: the float32 wire as floats (16 bytes where
//     the rows are 16-byte aligned, else 4, zero-filled past the window and
//     the stream), the int16 and mu-law wires as their raw bytes (the
//     16-byte pieces from the boundary at or below each row's first
//     sample, zero-filled past the stream; an odd hop or gap only moves the
//     first sample within its piece), dequantised where the A fragments are
//     loaded, with the window masked there: the same floats the float32
//     wire stages, so the same products; the copies of C and A run two
//     blocks ahead of the tensor cores (kStreamStages stages of C), and a
//     block's wgmma wait comes one block later;
//   * outside the resident layout a bf16 first layer is chunked (below),
//     and the activation buffers lie over regions that are dead by then.
// The chunked first layer (a bf16 one outside the resident layout, the fp32
// one on the tensor cores in every layout): one 64-column chunk of the
// product [frames, kProdLd] at a time, its bank through a ring in C's freed
// stages (kConvRing stages of one k-step; in the streamed layout
// kConvRingStreamed), its T shifted adds summed into the first activation
// buffer in t order; the span layout (and the resident one on the tensor
// cores) takes its chunks two at a time.
// Every layout issues the same products in the same order and sums in the
// same order, so they agree bit for bit.
//
// Built without --use_fast_math on purpose: tanhf, expf, expm1f, logf,
// sqrtf and the division keep their IEEE behaviour, including the NaN on
// silence. The dequantising products are __fmul_rn, so they are never
// contracted into an FMA: the int16 wire's samples are bit-exact with the
// JAX program's; the band DFT after them agrees to rounding (~1e-6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

// The source is built whole, or in parts compiled at once (one nvcc each,
// kernels/_build.py): with SD_PART = k a translation unit instantiates the
// launches of layout k only, and part 0 also holds the C interface. So
// everything below has external linkage in one named namespace, and the
// launches of the other layouts are declared extern.
namespace sd_fused {

constexpr int kMaxWarps = 8;
constexpr int kMaxGroups = kMaxWarps / 4;  // warpgroups of a CTA
constexpr int kMaxDevices = 64;
// Rows of C per shared-memory stage (TF32; bf16 has twice the rows in the
// same bytes), the k-steps they hold, and stages in flight.
constexpr int kBlockRows = 16;
constexpr int kBf16BlockRows = 32;
constexpr int kStepsPerBlock = 2;
constexpr int kStages = 3;
// The streamed layout's stages of C (one round's chunks each) and of A: its
// copies run two blocks ahead.
constexpr int kStreamStages = 4;
constexpr int kAStages = 3;
// Samples a thread has in flight while it stages the span.
constexpr int kStageUnroll = 8;
// A warpgroup's unit is one wgmma tile: kUnitFrames frames x kUnitCols
// columns of C (kUnitCols / 16 bin groups of kGroupBins bins, re and im).
constexpr int kUnitFrames = 64;
constexpr int kUnitCols = 64;
constexpr int kGroupBins = 8;
// Floats of one k-step (8 rows of TF32 or 16 of bf16) of one unit of one
// half: 8 x 64 floats.
constexpr int kStepFloats = 8 * kUnitCols;
// Rows of the bf16 conv filter bank per k-step.
constexpr int kBf16StepRows = 16;
// The streamed layout: floats past a k-block's rows between two staged
// frames (a row stride of 4 times an odd number puts a fragment's 32
// addresses on 32 banks), the mu-law table, and the row stride of one
// 64-column chunk of the bf16 conv product.
constexpr int kRowPad = 4;
constexpr int kLutFloats = 256;
constexpr int kProdLd = kUnitCols + 8;
// The chunked first layer: in the span layout, and in the resident one on
// the tensor cores, a warpgroup takes kConvPair chunks at once, in two
// independent accumulators that share its A fragments; its bank ring has
// kConvRing stages of one k-step of those chunks (both halves) in C's
// freed stages. The streamed layout has room for two stages of one chunk.
constexpr int kConvStepFloats = 2 * kStepFloats;
constexpr int kConvPair = 2;
constexpr int kConvRing = 3;
constexpr int kConvRingStreamed = 2;
// Rows of act_a a warp sums into at once after a chunk of the product.
constexpr int kAddRows = 4;
// conv_passes of the fp32 first layer on the tensor cores: three TF32
// products (the bf16 tiers count their products, 1, 3 or 4).
constexpr int kConvTf32 = -3;
// Rows of the TF32 conv filter bank per k-step.
constexpr int kTf32StepRows = 8;
// Stretches the first layer's dot product is cut into (a power of two, at
// most 32: they are summed across neighbouring lanes).
constexpr int kSplits = 8;
// Neighbouring evaluations a thread takes in the first layer.
constexpr int kL1Evals = 4;
constexpr float kDbPerNeper = 8.685889638065037f;  // 20 / ln(10)

enum Scaling { kLinear = 0, kLog = 1, kDb = 2 };
enum Layout { kResident = 0, kSpan = 1, kStreamed = 2 };
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
  int h1;            // width of the first layer
  int dft_passes;    // 0: TF32x3; 1, 3 or 4 bf16 products (the kernel's kDftPasses)
  int conv_passes;   // 0: fp32 first layer on the CUDA cores; kConvTf32: on
                     // the tensor cores; else its bf16 products (kConvPasses)
  int frames_input;  // 0: samples; 1: a [n, window] frames matrix (kFramesIn)
  int col_group;     // 0: the resident layout; -n the span layout, n the
                     // streamed one (kLayout), passes over k of n chunks
  int n_layers;      // layers of the MLP, the first one included
  int n_out;         // width of the last layer
  int transfer0;     // Transfer code of the first layer
};

// Elements between one lane's net operands and the next: 0 for a shared
// net, one net's size for per-lane nets.
struct LaneStrides {
  long long w1;
  long long c1;
  long long mids;
  long long out;  // out_a and out_c
  long long w1g;  // the tiled bf16 conv filter bank, in floats
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
// Floats of one staged row block: both halves, every k-step and chunk.
__host__ __device__ inline int block_floats(const Geometry& g) {
  return 2 * kStepsPerBlock * col_chunks(g) * kStepFloats;
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
// Floats between two staged rows of the frames input: the window rounded up
// to 32, plus 4, so that a fragment's rows fall on different banks.
__host__ __device__ inline int frame_stride(const Geometry& g) {
  return (g.window + 31) / 32 * 32 + 4;
}
// The layout of a geometry (the sign of col_group) and the chunks of C a
// pass over k covers outside the resident layout.
__host__ __device__ inline int layout_of(const Geometry& g) {
  return g.col_group == 0 ? kResident : (g.col_group < 0 ? kSpan : kStreamed);
}
__host__ __device__ inline int pass_chunks(const Geometry& g) {
  return g.col_group < 0 ? -g.col_group : g.col_group;
}
// Whether the first layer is the chunked GEMM: the fp32 one on the tensor
// cores in every layout, a bf16 one outside the resident layout.
__host__ __device__ inline bool conv_chunked(const Geometry& g) {
  return g.conv_passes == kConvTf32 || (g.conv_passes > 0 && g.col_group != 0);
}
// Chunks of kUnitCols columns of the conv GEMM's output (T * h1 columns),
// its k-steps over the bins (16 rows of bf16, 8 of TF32), and the bf16
// product's row stride in the resident layout (8 floats past the chunks,
// so that a fragment's rows fall on other banks).
__host__ __device__ inline int conv_chunks(const Geometry& g) {
  return (g.time_range * g.h1 + kUnitCols - 1) / kUnitCols;
}
__host__ __device__ inline int conv_steps(const Geometry& g) {
  const int rows = g.conv_passes == kConvTf32 ? kTf32StepRows : kBf16StepRows;
  return (g.bins + rows - 1) / rows;
}
__host__ __device__ inline int conv_ld(const Geometry& g) {
  return conv_chunks(g) * kUnitCols + 8;
}
// Floats of one half (hi or lo) of the tiled conv filter bank.
__host__ __device__ inline long long conv_half_floats(const Geometry& g) {
  return (long long)conv_steps(g) * conv_chunks(g) * kStepFloats;
}
__host__ __device__ inline long long round4(long long v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline long long max2(long long a, long long b) { return a > b ? a : b; }
// The staged span or frame rows.
__host__ __device__ inline long long rows_floats(const Geometry& g) {
  return g.frames_input ? (long long)g.frames * frame_stride(g) : span_floats(g);
}
// The resident layout's first region: the staged span or frame rows, and
// then the first layer's product, written there once the DFT is done with
// them: a bf16 one whole, the chunked one a chunk at a time.
__host__ __device__ inline long long staged_floats(const Geometry& g) {
  long long v = rows_floats(g);
  if (g.conv_passes > 0) v = max2(v, (long long)g.frames * conv_ld(g));
  if (g.conv_passes == kConvTf32) v = max2(v, (long long)g.frames * kProdLd);
  return v;
}
// The stages of C; under a bf16 first layer they also take its filter bank
// (the chunked one's bank ring needs less than kStages blocks).
__host__ __device__ inline long long stage_region_floats(const Geometry& g) {
  long long v = (long long)kStages * block_floats(g);
  if (g.conv_passes > 0) v = max2(v, 2 * conv_half_floats(g));
  return v;
}

// Outside the resident layout every region that grows with the geometry is
// bounded. A stage of C holds one row block of col_group chunks:
__host__ __device__ inline int stream_stage_floats(const Geometry& g) {
  return 2 * kStepsPerBlock * pass_chunks(g) * kStepFloats;
}
__host__ __device__ inline long long acts_floats(const Geometry& g) {
  return round4((long long)(g.frames - g.time_range + 1) * g.max_width);
}
// The span layout's regions, in order:
//   rows    the span or frame rows; then the chunked first layer's product
//           [frames, kProdLd]; then the second activation buffer
//   ring    the stages of C; then the chunked first layer's bank ring, or
//           the fp32 first layer's weights where they fit
//   spec    the spectrogram [frames, bins]
//   act_a   the first activation buffer [tile, max_width]
//   sums    the row sums of squares [frames] and the norms [tile]
__host__ __device__ inline long long span_rows_region_floats(const Geometry& g) {
  long long v = max2(round4(rows_floats(g)), acts_floats(g));
  if (conv_chunked(g)) v = max2(v, (long long)g.frames * kProdLd);
  return v;
}
// The streamed layout's regions, in order:
//   ring    kStreamStages stages of C; under the chunked first layer also
//           its bank ring (kConvRingStreamed stages of one k-step) and one
//           chunk of its product [frames, kProdLd], one after the other
//   act_a   the first activation buffer [tile, max_width]; during the band
//           DFT kAStages staged k-blocks of A [frames, rows + kRowPad] and
//           the mu-law table
//   spec    the spectrogram [frames, bins]; after the first layer the
//           second activation buffer [tile, max_width]
//   sums    the row sums of squares [frames] and the norms [tile]
// Each is a whole number of 16-byte chunks.
__host__ __device__ inline int a_stride(const Geometry& g) {
  return (g.dft_passes ? kBf16BlockRows : kBlockRows) + kRowPad;
}
__host__ __device__ inline long long ring_floats(const Geometry& g) {
  long long v = (long long)kStreamStages * stream_stage_floats(g);
  if (conv_chunked(g)) {
    v = max2(v, (long long)kConvRingStreamed * kConvStepFloats + (long long)g.frames * kProdLd);
  }
  return v;
}
__host__ __device__ inline long long act_region_floats(const Geometry& g) {
  return max2(acts_floats(g), (long long)kAStages * g.frames * a_stride(g) + kLutFloats);
}
__host__ __device__ inline long long spec_region_floats(const Geometry& g) {
  return max2(acts_floats(g), (long long)g.frames * g.bins);
}

__host__ __device__ inline long long smem_floats(const Geometry& g) {
  const long long tile = g.frames - g.time_range + 1;
  switch (layout_of(g)) {
    case kStreamed:
      return ring_floats(g) + act_region_floats(g) + spec_region_floats(g) +
             round4(g.frames + tile);
    case kSpan:
      return span_rows_region_floats(g) + (long long)kStages * stream_stage_floats(g) +
             round4((long long)g.frames * g.bins) + acts_floats(g) + round4(g.frames + tile);
    default:
      return staged_floats(g) + stage_region_floats(g) +
             (long long)g.frames * g.bins + g.frames + 2 * tile * g.max_width;
  }
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
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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

// d += a @ b for one warpgroup: a [64, 16] bf16 from registers (this
// warp's 16 rows in the m16n8k16 fragment layout, two values a register),
// b [16, 64] bf16 from shared memory in the same core-matrix layout as the
// TF32 tiles (16 bytes of k a row), d as in wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The m64n32 forms of wgmma_tf32 and wgmma_bf16: d's first 16 registers
// (4 column tiles), b a [k, 32] tile in the same layout (its first 4
// column blocks).
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The bf16 halves of two values, packed as a fragment register holds them
// (the first value in the low half): hi = bf16(v), lo = bf16(v - hi), both
// rounded to nearest even, as the JAX kernel's split_dot rounds them.
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A bf16 k-step's A fragment from 8 values a thread loaded: v[h][q] is
// column k0 + 8h + tig + 4 * (q >> 1) of row gid + 8 * (q & 1). Register
// 2h + r holds fragment columns 8h + 2*tig and 8h + 2*tig + 1 of row r: the
// columns k0 + 8h + tig and k0 + 8h + tig + 4, which is the permutation of
// k that tile_dft_matrix_bf16 and tile_conv_bank_bf16 apply to B's rows.
template <bool kLo>
__device__ __forceinline__ void pack_bf16_step(const float (&v)[2][4], uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t l;
      split_bf16x2(v[h][r], v[h][r + 2], hi[2 * h + r], l);
      if (kLo) lo[2 * h + r] = l;
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}
// A copy of `bytes` (0 .. 16) of the 16 at `src`, the rest of the 16 at
// `dst` zero-filled; `src` is read only where `bytes` > 0, and 16-byte
// aligned like `dst`.
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
// One float, or zero where `bytes` is 0.
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

// Sample: the wire's type. kDftPasses: 0 for the TF32x3 band DFT, else its
// bf16 products; kConvPasses: 0 for the fp32 first layer on the CUDA cores,
// kConvTf32 for it on the tensor cores (an instantiation of its own, so
// that the CUDA-core one keeps its registers), else the bf16 products of
// its conv GEMM; kFramesIn: x holds [n, window] frames; kLayout: the
// shared-memory layout (Layout).
template <typename Sample, int kDftPasses, int kConvPasses, bool kFramesIn, int kLayout>
__global__ void __launch_bounds__(kMaxWarps * 32) fused_detector_kernel(
    const Sample* __restrict__ x,         // [lanes, ld]: lane samples on the wire
    long long ld, long long n, long long n_evals,
    const float* __restrict__ cs,    // C's TF32 or bf16 halves in the kernel's tiles
    const float* __restrict__ w1,    // per net [T*bins, h1]
    const float* __restrict__ w1g,   // per net, the tiled conv bank (bf16, or TF32)
    const float* __restrict__ c1,    // per net [h1]
    const float* __restrict__ mids,  // per net, per hidden layer: W [in, out], b [out]
    const float* __restrict__ out_a, const float* __restrict__ out_c,
    float* __restrict__ out,         // [lanes, n_evals, outputs]
    const int* __restrict__ layers,  // [2, n_layers]: widths, then Transfer codes
    Geometry g, LaneStrides ls, Dequant dq,
    unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
  const long long lane = blockIdx.y;
  x += lane * ld;
  w1 += lane * ls.w1;
  w1g += lane * ls.w1g;
  c1 += lane * ls.c1;
  mids += lane * ls.mids;
  out_a += lane * ls.out;
  out_c += lane * ls.out;
  out += lane * n_evals * g.n_out;
  const int b = g.bins;
  const int T = g.time_range;
  const int tile = g.frames - T + 1;
  const int mw = g.max_width;
  constexpr bool kBf16Dft = kDftPasses > 0;
  constexpr int kRows = kBf16Dft ? kBf16BlockRows : kBlockRows;
  const long long span = span_floats(g);
  const int kp = (g.window + kRows - 1) / kRows * kRows;
  const int chunks = col_chunks(g);
  const int block = block_floats(g);
  // A's rows: the span at stride hop from the gap, or the staged frame rows
  const int rs = kFramesIn ? frame_stride(g) : g.hop;
  const int r0 = kFramesIn ? 0 : g.gap;
  // chunks of C a pass over k covers, and the floats of one stage of C
  const int per_pass = kLayout == kResident ? chunks : pass_chunks(g);
  const int sfl = kLayout == kResident ? block : stream_stage_floats(g);
  constexpr int kC = kLayout == kStreamed ? kStreamStages : kStages;  // stages of C
  float* samples = smem;   // the span or frame rows (resident and span layouts)
  float* stages;           // [kC][sfl]: C's stages, or the streamed ring
  float* spec;             // [frames, bins]
  float* rowsq;            // [frames]
  float* act_a;            // [tile, max_width]
  float* act_b;            // [tile, max_width]
  float* norms;            // [tile]
  if constexpr (kLayout == kStreamed) {
    stages = smem;
    act_a = stages + ring_floats(g);
    spec = act_a + act_region_floats(g);
    act_b = spec;
    rowsq = spec + spec_region_floats(g);
    norms = rowsq + g.frames;
  } else if constexpr (kLayout == kSpan) {
    stages = samples + span_rows_region_floats(g);
    spec = stages + kC * sfl;
    act_a = spec + round4((long long)g.frames * b);
    rowsq = act_a + acts_floats(g);
    norms = rowsq + g.frames;
    act_b = samples;
  } else {
    stages = samples + staged_floats(g);
    spec = stages + stage_region_floats(g);
    rowsq = spec + g.frames * b;
    act_a = rowsq + g.frames;
    act_b = act_a + tile * mw;
    // the sliding norms are kept in the second activation buffer until the
    // hidden layers need it
    norms = act_b;
  }

  const long long e0 = (long long)blockIdx.x * tile;
  const long long start = e0 * g.hop;
  long long t_prof = prof != nullptr ? clock64() : 0;

  // Row block kb of chunks c0 .. c0 + gcur - 1 into stage kb % kC:
  // both halves (hi first), or the hi half alone for one bf16 pass. Over
  // every chunk a block is one contiguous piece of `cs`, else one piece per
  // half and k-step. The caller commits the group.
  const int n_blocks = kp / kRows;
  constexpr int kSteps = kStepsPerBlock;
  constexpr int kPieces = (kDftPasses == 1 ? 1 : 2) * kSteps;
  auto prefetch = [&](int kb, int c0, int gcur) {
    if (kb >= n_blocks) return;
    float* dst = stages + (kb % kC) * sfl;
    const float* src = cs + (long long)kb * block;
    if (kLayout == kResident || gcur == chunks) {
      for (int i = 4 * threadIdx.x; i < kPieces * chunks * kStepFloats; i += 4 * blockDim.x) {
        cp_async16(dst + i, src + i);
      }
    } else {
      const int piece = gcur * kStepFloats;
      src += c0 * kStepFloats;
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        for (int o = 4 * threadIdx.x; o < piece; o += 4 * blockDim.x) {
          cp_async16(dst + p * piece + o, src + (long long)p * chunks * kStepFloats + o);
        }
      }
    }
  };
  // kC - 1 blocks of the first pass in flight while the span is
  // staged; a group is committed per block even when there is none left,
  // so that the wait counts stay the same
  if constexpr (kLayout != kStreamed) {
#pragma unroll
    for (int kb = 0; kb < kC - 1; ++kb) {
      prefetch(kb, 0, per_pass);
      cp_async_commit();
    }
  }

  // 1. this tile's sample span, dequantised; reads past the stream are
  //    zero. Where the lane's samples are 16-byte aligned they are read 16
  //    bytes at a time, kStageUnroll loads in flight per thread. Frames
  //    input: rows e0 .. e0 + frames - 1 of the frames matrix, each at
  //    frame_stride, rows past the matrix zero. The streamed layout stages
  //    A one k-block at a time in the band DFT (stage_a below); here only
  //    the mu-law table, beside those blocks.
  float* lut_s = act_a + kAStages * g.frames * a_stride(g);  // the streamed layout's table
  if constexpr (kLayout == kStreamed) {
    if (sizeof(Sample) == 1) {
      for (int i = threadIdx.x; i < kLutFloats; i += blockDim.x) {
        lut_s[i] = dequant(static_cast<Sample>(static_cast<int8_t>(i)), dq);
      }
      __syncthreads();
    }
  } else if constexpr (kFramesIn) {
    const int stride = frame_stride(g);
    const float* xs = reinterpret_cast<const float*>(x) + e0 * g.window;
    const long long left = n - e0;  // rows of the matrix from e0
    const int rows = left < 0 ? 0 : (left < g.frames ? static_cast<int>(left) : g.frames);
    if ((g.window & 3) == 0 && (reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
      const int per_row = g.window / 4;
      const int n_vec = rows * per_row;
      const float4* xv = reinterpret_cast<const float4*>(xs);
      const int step = blockDim.x * kStageUnroll;
      for (int v0 = threadIdx.x; v0 < n_vec; v0 += step) {
        float4 raw[kStageUnroll];
#pragma unroll
        for (int q = 0; q < kStageUnroll; ++q) {
          const int v = v0 + q * blockDim.x;
          if (v < n_vec) raw[q] = __ldcs(xv + v);
        }
#pragma unroll
        for (int q = 0; q < kStageUnroll; ++q) {
          const int v = v0 + q * blockDim.x;
          if (v < n_vec) {
            const int r = v / per_row;
            *reinterpret_cast<float4*>(samples + r * stride + 4 * (v - r * per_row)) = raw[q];
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < rows * g.window; i += blockDim.x) {
        const int r = i / g.window;
        samples[r * stride + i - r * g.window] = xs[i];
      }
    }
    for (int i = rows * stride + threadIdx.x; i < g.frames * stride; i += blockDim.x) {
      samples[i] = 0.0f;
    }
  } else {
    // The mu-law expansion costs an expm1f a sample: its 256 values are
    // computed once, by the same expression, into the stage of C that no
    // copy is in flight to, and looked up from there.
    const float* lut = stages + (kC - 1) * sfl;
    if (sizeof(Sample) == 1) {
      float* table = stages + (kC - 1) * sfl;
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
  // 64-frame groups of the CTA; a warpgroup's units (a frame group and
  // kDual chunks) go chunk by chunk through a pass, so that a round's
  // warpgroups share their chunks of C
  const int fg = g.frames / kUnitFrames;
  // |X| and scaling of one unit's accumulators into the spectrogram: column
  // tile 2j holds re and tile 2j + 1 im of bin group 4*ch + j0 + j, j <
  // nj (4 for a whole chunk, 2 for a half from bin group j0); this thread
  // has columns 2*tig, 2*tig + 1 of rows gid and gid + 8
  auto magnitudes = [&](const float (&acc)[32], int mg, int ch, int j0 = 0, int nj = 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = (4 * ch + j0 + j) * kGroupBins + 2 * tig + (q & 1);
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
  };
  // Outside the resident layout a warpgroup takes kDual chunks of a pass at
  // once, in independent accumulators (two chains of products on the
  // tensor cores), or, where it has one chunk only, that chunk's two halves
  // of 32 columns; the resident layout keeps its registers for two CTAs an
  // SM.
  constexpr int kDual = kLayout == kResident ? 1 : 2;
  // The products of one row block on its stage `cb` (chunks cl .. cl + nd -
  // 1 of a pass over gcur chunks, accumulator d for chunk cl + d, or for
  // half d of chunk cl where kDual > nd = 1), small terms first within each
  // k-step, each into its own accumulator: TF32 a_lo*c_hi + a_hi*c_lo +
  // a_hi*c_hi, or the tier's bf16 passes; fenced and committed.
  auto block_products = [&](float (&acc)[kDual][32], const uint32_t (&a_hi)[kSteps][4],
                            const uint32_t (&a_lo)[kSteps][4], const float* cb, int gcur,
                            int cl, int nd) {
    const int piece = gcur * kStepFloats;
    // the products of k-step ks into accumulator d from B at `step`, in
    // columns of 64 or (kN32) of 32
    auto products = [&](auto n32, float (&acc_d)[32], int ks, const float* step) {
      constexpr bool kN32 = decltype(n32)::value;
      const uint64_t b_hi = b_descriptor(step);
      const uint64_t b_lo = b_descriptor(step + kSteps * piece);
      if constexpr (kBf16Dft) {
        auto mma = [&](const uint32_t (&a)[4], uint64_t bd) {
          if constexpr (kN32) {
            wgmma_bf16_n32(acc_d, a, bd);
          } else {
            wgmma_bf16(acc_d, a, bd);
          }
        };
        if constexpr (kDftPasses > 1) {
          if constexpr (kDftPasses == 4) mma(a_lo[ks], b_lo);
          mma(a_lo[ks], b_hi);
          mma(a_hi[ks], b_lo);
        }
        mma(a_hi[ks], b_hi);
      } else {
        auto mma = [&](const uint32_t (&a)[4], uint64_t bd) {
          if constexpr (kN32) {
            wgmma_tf32_n32(acc_d, a, bd);
          } else {
            wgmma_tf32(acc_d, a, bd);
          }
        };
        mma(a_lo[ks], b_hi);
        mma(a_hi[ks], b_lo);
        mma(a_hi[ks], b_hi);
      }
    };
    // each case one straight sequence from the fence to the commit, so
    // that ptxas keeps the products in flight together
    if (kDual > 1 && nd == 1) {
      // one chunk: its two halves of 32 columns (column blocks 4d .. 4d + 3)
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int d = 0; d < kDual; ++d) {
          products(std::true_type{}, acc[d], ks, cb + (ks * gcur + cl) * kStepFloats + d * 4 * 64);
        }
      }
      wgmma_commit();
    } else {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int d = 0; d < kDual; ++d) {
          products(std::false_type{}, acc[d], ks, cb + (ks * gcur + cl + d) * kStepFloats);
        }
      }
      wgmma_commit();
    }
  };
  // keeps fragments alive (the tensor cores read them until the wait)
  auto pin = [&](const uint32_t (&hi)[kSteps][4], const uint32_t (&lo)[kSteps][4]) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kDftPasses == 1) {
          asm volatile("" ::"r"(hi[ks][q]));
        } else {
          asm volatile("" ::"r"(hi[ks][q]), "r"(lo[ks][q]));
        }
      }
    }
  };
  if constexpr (kLayout == kStreamed) {
    // The streamed layout: C's chunks in passes of col_group, each pass's
    // units in rounds as below. A one k-block at a time, only the rows of
    // the 64-frame groups the round's units use, in kAStages buffers taken
    // in turn; block kb + 2's copies (C and A) are issued while the tensor
    // cores work on block kb, and block kb's wgmma wait comes one block
    // later, so shared memory does not grow with the window, the hop or the
    // bins. The products, and so the spectrogram, are the resident
    // layout's bit for bit.
    const int ast = a_stride(g);
    const int a_buf = g.frames * ast;
    const float* xf = reinterpret_cast<const float*>(x);
    // Staged frame f's row starts at row0 + f * grs (the span from the gap,
    // or the frames matrix from row e0); `left` values lie from row0 on.
    const int grs = kFramesIn ? g.window : g.hop;
    const float* row0 = kFramesIn ? xf + e0 * g.window : xf + start + g.gap;
    const long long left = kFramesIn ? (n - e0) * g.window : n - start - g.gap;
    // 16-byte copies where every staged row starts on a 16-byte boundary; a
    // zero-filled copy reads nothing, from an address aligned as theirs
    const bool vec16 = sizeof(Sample) == 4 && grs % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(row0) & 15) == 0;
    auto expand_s = [&](Sample v) {
      return sizeof(Sample) == 1 ? lut_s[static_cast<uint8_t>(v)] : dequant(v, dq);
    };
    // The int16 and mu-law wires: a staged frame's row of a block is its raw
    // bytes, the kRawChunks 16-byte pieces of the wire that hold its kRows
    // samples (the piece holding the first one, and on), at kRawStride bytes
    // a frame (an odd number of pieces: the fragment loads of 8 frames fall
    // on distinct banks), kAStages buffers of raw_buf bytes in the first
    // activation buffer where the float32 ring would lie. A frame's first
    // sample sits at the same offset of its first piece in every block
    // (kRows samples are a whole number of pieces), raw_off below. Pieces
    // reach back at most 15 bytes before a row and forward past it; the
    // bytes before the lane's first sample lie in the same allocation
    // (device allocations are aligned to 256 bytes), those past the stream
    // are zero-filled.
    constexpr bool kRaw = sizeof(Sample) != 4;
    constexpr int kRawChunks = kRows * static_cast<int>(sizeof(Sample)) / 16 + 1;
    constexpr int kRawStride = (kRawChunks | 1) * 16;
    const int raw_buf = g.frames * kRawStride;
    unsigned char* raw = reinterpret_cast<unsigned char*>(act_a);
    const uintptr_t raw0 = reinterpret_cast<uintptr_t>(x) + (start + g.gap) * sizeof(Sample);
    const uintptr_t raw_end = raw0 + (left > 0 ? left : 0) * sizeof(Sample);
    const uintptr_t raw_any = reinterpret_cast<uintptr_t>(x) & ~static_cast<uintptr_t>(15);
    auto raw_off = [&](int f) {  // byte offset of frame f's first sample in its piece
      return static_cast<int>((raw0 + (long long)f * g.hop * sizeof(Sample)) & 15);
    };
    // rows kb * kRows .. + kRows - 1 of the nf frames from f0 into A's
    // buffer `stage` (frame f0 + i at row i), by cp.async (the caller
    // commits): the float32 wire as floats, zero past the window, the
    // stream or the frames matrix; the other wires as raw pieces, zero past
    // the stream (the fragment loads mask the window and dequantise)
    auto stage_a = [&](int kb, int f0, int nf, int stage) {
      const int k0 = kb * kRows;
      if constexpr (kRaw) {
        unsigned char* dst = raw + stage * raw_buf;
        for (int i = threadIdx.x; i < nf * kRawChunks; i += blockDim.x) {
          const int f = i / kRawChunks;
          const int c = i - f * kRawChunks;
          const uintptr_t row = raw0 + ((long long)(f0 + f) * g.hop + k0) * sizeof(Sample);
          const uintptr_t src = (row & ~static_cast<uintptr_t>(15)) + 16 * c;
          const long long have = raw_end > src ? static_cast<long long>(raw_end - src) : 0;
          const int bytes = have >= 16 ? 16 : static_cast<int>(have);
          cp_async16_zfill(reinterpret_cast<float*>(dst + f * kRawStride + 16 * c),
                           reinterpret_cast<const float*>(bytes ? src : raw_any), bytes);
        }
      } else {
        float* buf = act_a + stage * a_buf;
        if (vec16) {
          constexpr int kPer = kRows / 4;  // 16-byte copies a frame
          for (int i = threadIdx.x; i < nf * kPer; i += blockDim.x) {
            const int f = i / kPer;
            const int k = k0 + 4 * (i - f * kPer);
            const long long at = (long long)(f0 + f) * grs + k;
            const long long have = min((long long)(g.window - k), left - at);
            const int bytes = have <= 0 ? 0 : (have >= 4 ? 16 : 4 * static_cast<int>(have));
            cp_async16_zfill(buf + f * ast + k - k0, bytes ? row0 + at : row0, bytes);
          }
        } else {
          for (int i = threadIdx.x; i < nf * kRows; i += blockDim.x) {
            const int f = i / kRows;
            const int k = k0 + i - f * kRows;
            const long long at = (long long)(f0 + f) * grs + k;
            const bool in = k < g.window && at < left;
            cp_async4_zfill(buf + f * ast + k - k0, in ? row0 + at : row0, in ? 4 : 0);
          }
        }
      }
    };
    for (int c0 = 0; c0 < chunks; c0 += per_pass) {
      const int gcur = min(per_pass, chunks - c0);
      const int units = fg * ((gcur + kDual - 1) / kDual);
      for (int u0 = 0; u0 < units; u0 += groups_n) {
        const int u = u0 + group;
        const bool active = u < units;
        // an idle warpgroup repeats the round's last unit and discards it, so
        // that every warpgroup's products take one path (ptxas keeps them in
        // flight only then)
        const int ue = active ? u : units - 1;
        const int mg = ue % fg;            // which 64 frames
        const int cl = ue / fg * kDual;    // its first chunk of the pass
        const int nd = min(kDual, gcur - cl);
        // the frames of the round's units: fg_n groups of 64 from mg0, or
        // every frame where they wrap around
        const int mg0 = u0 % fg;
        const int fg_n = min(fg, min(units - u0, groups_n));
        const int f_a = mg0 + fg_n <= fg ? mg0 * kUnitFrames : 0;
        const int nf = mg0 + fg_n <= fg ? fg_n * kUnitFrames : g.frames;
        const int arow = (mg * kUnitFrames - f_a + wrow + gid) * ast + tig;
        // the raw wires: this thread's two frames' rows and first samples
        const int rrow = mg * kUnitFrames - f_a + wrow + gid;
        const int roff0 = kRaw ? raw_off(mg * kUnitFrames + wrow + gid) : 0;
        const int roff1 = kRaw ? raw_off(mg * kUnitFrames + wrow + gid + 8) : 0;
        float acc[kDual][32];
#pragma unroll
        for (int d = 0; d < kDual; ++d) {
#pragma unroll
          for (int q = 0; q < 32; ++q) acc[d][q] = 0.0f;
        }
        // blocks 0 and 1 of C and A in flight, a group each
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          if (kb < n_blocks) {
            prefetch(kb, c0, gcur);
            stage_a(kb, f_a, nf, kb);
          }
          cp_async_commit();
        }
        uint32_t h0[kSteps][4] = {}, l0[kSteps][4] = {}, h1f[kSteps][4] = {}, l1f[kSteps][4] = {};
        // block kb into fragments (hi, lo) and its products; then block kb +
        // 2's copies; then the wait for block kb - 1, whose fragments (phi,
        // plo) the tensor cores read until then
        auto dft_block = [&](int kb, uint32_t (&hi)[kSteps][4], uint32_t (&lo)[kSteps][4],
                             const uint32_t (&phi)[kSteps][4], const uint32_t (&plo)[kSteps][4]) {
          cp_async_wait<1>();
          // C's and A's block kb have landed, every warpgroup's products of
          // block kb - 2 are done and its fragments of block kb - 1 loaded:
          // the stage of C and the A buffer written next are free
          __syncthreads();
          stamp(prof, 4, t_prof);
          if constexpr (kRaw) {
            static_assert(!kBf16Dft, "the int16 and mu-law wires run in full fp32 only");
            // the fragments from the raw rows, dequantised as loaded (the
            // float32 wire's staged value), zero past the window
            const unsigned char* rb = raw + (kb % kAStages) * raw_buf;
            const Sample* s0 = reinterpret_cast<const Sample*>(rb + rrow * kRawStride + roff0);
            const Sample* s1 = reinterpret_cast<const Sample*>(rb + (rrow + 8) * kRawStride + roff1);
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int kc = ks * 8 + (q >> 1) * 4 + tig;
                const float v =
                    kb * kRows + kc < g.window ? expand_s(((q & 1) ? s1 : s0)[kc]) : 0.0f;
                hi[ks][q] = to_tf32(v);
                lo[ks][q] = to_tf32(v - __uint_as_float(hi[ks][q]));
              }
            }
            block_products(acc, hi, lo, stages + (kb % kC) * sfl, gcur, cl, nd);
          } else {
            const float* a0 = act_a + (kb % kAStages) * a_buf + arow;
            const float* a1 = a0 + 8 * ast;
            // the fragments as the resident layout loads them, from the
            // block's rows (zero past the window already)
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
              if constexpr (kBf16Dft) {
                float v[2][4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
#pragma unroll
                  for (int q = 0; q < 4; ++q) {
                    v[h][q] = ((q & 1) ? a1 : a0)[ks * 16 + h * 8 + (q >> 1) * 4];
                  }
                }
                pack_bf16_step<(kDftPasses > 1)>(v, hi[ks], lo[ks]);
              } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float v = ((q & 1) ? a1 : a0)[ks * 8 + (q >> 1) * 4];
                  hi[ks][q] = to_tf32(v);
                  lo[ks][q] = to_tf32(v - __uint_as_float(hi[ks][q]));
                }
              }
            }
            block_products(acc, hi, lo, stages + (kb % kC) * sfl, gcur, cl, nd);
          }
          if (kb + 2 < n_blocks) {
            prefetch(kb + 2, c0, gcur);
            stage_a(kb + 2, f_a, nf, (kb + 2) % kAStages);
          }
          cp_async_commit();
          stamp(prof, 6, t_prof);
          wgmma_wait<1>();
          pin(phi, plo);
          stamp(prof, 5, t_prof);
        };
        for (int kb = 0; kb < n_blocks; kb += 2) {
          dft_block(kb, h0, l0, h1f, l1f);
          if (kb + 1 < n_blocks) dft_block(kb + 1, h1f, l1f, h0, l0);
        }
        wgmma_wait<0>();
        pin(h0, l0);
        pin(h1f, l1f);
        __syncthreads();  // before the next round's copies overwrite a stage
        if (active) {
#pragma unroll
          for (int d = 0; d < kDual; ++d) {
            if (kDual > nd) {
              magnitudes(acc[d], mg, c0 + cl, 2 * d, 2);
            } else {
              magnitudes(acc[d], mg, c0 + cl + d);
            }
          }
        }
      }
    }
  } else {
    // The resident layout: one pass over every chunk; the span layout:
    // passes over col_group chunks, C's blocks of each pass streamed again.
    // A from the staged span either way.
    for (int c0 = 0; c0 < chunks; c0 += per_pass) {
      const int gcur = min(per_pass, chunks - c0);
      const int units = fg * ((gcur + kDual - 1) / kDual);
      for (int u0 = 0; u0 < units; u0 += groups_n) {
        const int u = u0 + group;
        const bool active = u < units;
        // outside the resident layout an idle warpgroup repeats the round's
        // last unit and discards it, as in the streamed layout
        const bool issue = kLayout == kResident ? active : true;
        const int ue = active ? u : units - 1;
        const int mg = ue % fg;          // which 64 frames
        const int cl = ue / fg * kDual;  // its first chunk of the pass
        const int nd = min(kDual, gcur - cl);
        // rows gid and gid + 8 of this warp's 16 frames, at column tig
        const float* arow0 = samples + (long long)(mg * kUnitFrames + wrow + gid) * rs + r0 + tig;
        const float* arow1 = arow0 + 8 * rs;
        float acc[kDual][32];
#pragma unroll
        for (int d = 0; d < kDual; ++d) {
#pragma unroll
          for (int q = 0; q < 32; ++q) acc[d][q] = 0.0f;
        }
        // The A fragments of one row block, split into halves. TF32: for each
        // k-step of 8, (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig
        // + 4); bf16: for each k-step of 16 the same columns and those 8 further
        // (pack_bf16_step). Zero past the window.
        auto load_a = [&](int kb, uint32_t (&hi)[kSteps][4], uint32_t (&lo)[kSteps][4]) {
          if constexpr (kBf16Dft) {
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
              float v[2][4];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k0 = kb * kRows + ks * 16 + h * 8;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int k = k0 + (q >> 1) * 4;
                  v[h][q] = k + tig < g.window ? ((q & 1) ? arow1 : arow0)[k] : 0.0f;
                }
              }
              pack_bf16_step<(kDftPasses > 1)>(v, hi[ks], lo[ks]);
            }
          } else {
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
          }
        };
        if (c0 > 0 || u0 > 0) {
#pragma unroll
          for (int kb = 0; kb < kC - 1; ++kb) {
            prefetch(kb, c0, gcur);
            cp_async_commit();
          }
        } else {
          __syncthreads();  // the span is staged
        }
        uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
        if (issue) load_a(0, a_hi, a_lo);
        for (int kb = 0; kb < n_blocks; ++kb) {
          cp_async_wait<kC - 2>();
          // block kb has landed, and every warp is done with block kb - 1, whose
          // stage the next prefetch overwrites
          __syncthreads();
          prefetch(kb + kC - 1, c0, gcur);
          cp_async_commit();
          stamp(prof, 4, t_prof);
          if (issue) {
            block_products(acc, a_hi, a_lo, stages + (kb % kC) * sfl, gcur, cl, nd);
            // the next block's fragments are loaded while the tensor cores
            // run; these ones are read by them until the wait, so they stay
            // where they are until then
            uint32_t n_hi[kSteps][4], n_lo[kSteps][4];
            const bool more = kb + 1 < n_blocks;
            if (more) load_a(kb + 1, n_hi, n_lo);
            wgmma_wait();
            pin(a_hi, a_lo);
            if (more) {
#pragma unroll
              for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  a_hi[ks][q] = n_hi[ks][q];
                  if constexpr (kDftPasses != 1) a_lo[ks][q] = n_lo[ks][q];
                }
              }
            }
          }
          stamp(prof, 5, t_prof);
        }
        __syncthreads();  // before the next round's prefetch overwrites a stage
        if (active) {
#pragma unroll
          for (int d = 0; d < kDual; ++d) {
            if (kDual > nd) {
              magnitudes(acc[d], mg, c0 + cl, 2 * d, 2);
            } else {
              magnitudes(acc[d], mg, c0 + cl + d);
            }
          }
        }
      }
    }
  }
  // The stages of C are free now: the first layer's weights go there, when
  // they fit, while the row sums are taken (L1 is small beside this much
  // shared memory, and the sample loads stream through it). Under a bf16
  // first layer in the resident layout its tiled filter bank goes there
  // (the layout makes room): both halves, or the hi half alone for one
  // pass. The chunked first layer streams its bank through them instead,
  // one k-step of one chunk a stage, its first stages in flight already.
  const int h1 = g.h1;
  const int n_feat = T * b;
  constexpr bool chunked =
      kConvPasses == kConvTf32 || (kConvPasses > 0 && kLayout != kResident);
  const bool w1_vec = (h1 & 3) == 0 && (reinterpret_cast<uintptr_t>(w1) & 15) == 0;
  const long long free_floats = kLayout == kStreamed ? ring_floats(g) : (long long)kC * sfl;
  const bool w1_staged = kConvPasses == 0 && !chunked && w1_vec && n_feat * h1 <= free_floats;
  const int cchunks = conv_chunks(g);
  const int ksteps = conv_steps(g);
  const long long half = conv_half_floats(g);
  // The chunked layer's order: per group of kPair chunks (of pair_n where
  // rounds repeat, one), rounds of 64-frame groups, per round its k-steps;
  // stage q of the bank ring holds k-step q % ksteps of the group's chunks
  constexpr int kRing = kLayout == kStreamed ? kConvRingStreamed : kConvRing;
  constexpr int kPair =
      kLayout == kSpan || (kLayout == kResident && kConvPasses == kConvTf32) ? kConvPair : 1;
  const int c_rounds = (fg + groups_n - 1) / groups_n;
  const int pair_n = c_rounds == 1 ? kPair : 1;
  const int c_total = (cchunks + pair_n - 1) / pair_n * c_rounds * ksteps;
  auto fetch_bank = [&](int q) {
    if (q < c_total) {
      constexpr int kHalves = kConvPasses == 1 ? 1 : 2;
      const int s = q % ksteps;
      const int cc = q / (ksteps * c_rounds) * pair_n;
      // the group's chunks lie side by side in each half's k-step
      const int n = min(pair_n, cchunks - cc) * kStepFloats;
      float* dst = stages + (q % kRing) * kPair * kConvStepFloats;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const float* src = w1g + h * half + ((long long)s * cchunks + cc) * kStepFloats;
        for (int o = 4 * threadIdx.x; o < n; o += 4 * blockDim.x) {
          cp_async16(dst + h * kPair * kStepFloats + o, src + o);
        }
      }
    }
    cp_async_commit();
  };
  if constexpr (chunked) {
    for (int q = 0; q < kRing - 1; ++q) fetch_bank(q);
  } else if constexpr (kConvPasses > 0) {
    const long long bank = (kConvPasses == 1 ? 1 : 2) * half;
    for (long long i = 4 * threadIdx.x; i < bank; i += 4 * blockDim.x) {
      cp_async16(stages + i, w1g + i);
    }
    cp_async_commit();
  } else if (w1_staged) {
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
  // the sliding norm of each evaluation
  if (g.has_l2) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      float norm = 0.0f;
      for (int t = 0; t < T; ++t) norm += rowsq[e + t];
      norms[e] = sqrtf(norm);
    }
  }
  if (!chunked && (kConvPasses > 0 || w1_staged)) cp_async_wait<0>();
  __syncthreads();

  // The products of k-step s of the conv filter-bank GEMM [frames, bins] @
  // [bins, T*h1] for
  // this warpgroup's 64 frames from 64 * mg, on the tensor cores, A from the
  // fp32 spectrogram split as loaded (the DFT's column order within a
  // k-step): the TF32 products of the fp32 layer (8 bins a k-step), or the
  // tier's bf16 ones (16). B's hi half at `bank`, its lo half `lo` floats
  // further.
  auto conv_load = [&](int mg, int s, uint32_t (&a_hi)[4], uint32_t (&a_lo)[4]) {
    const float* srow0 = spec + (mg * kUnitFrames + wrow + gid) * b + tig;
    const float* srow1 = srow0 + 8 * b;
    if constexpr (kConvPasses == kConvTf32) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = s * kTf32StepRows + (q >> 1) * 4;
        const float v = k + tig < b ? ((q & 1) ? srow1 : srow0)[k] : 0.0f;
        a_hi[q] = to_tf32(v);
        a_lo[q] = to_tf32(v - __uint_as_float(a_hi[q]));
      }
    } else {
      float v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = s * kBf16StepRows + h * 8 + (q >> 1) * 4;
          v[h][q] = k + tig < b ? ((q & 1) ? srow1 : srow0)[k] : 0.0f;
        }
      }
      pack_bf16_step<(kConvPasses > 1)>(v, a_hi, a_lo);
    }
  };
  auto conv_mma = [&](float (&acc)[32], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                      const float* bank, long long lo) {
    const uint64_t b_hi = b_descriptor(bank);
    if constexpr (kConvPasses == kConvTf32) {
      const uint64_t b_lo = b_descriptor(bank + lo);
      wgmma_tf32(acc, a_lo, b_hi);
      wgmma_tf32(acc, a_hi, b_lo);
      wgmma_tf32(acc, a_hi, b_hi);
    } else {
      if constexpr (kConvPasses > 1) {
        const uint64_t b_lo = b_descriptor(bank + lo);
        if constexpr (kConvPasses == 4) wgmma_bf16(acc, a_lo, b_lo);
        wgmma_bf16(acc, a_lo, b_hi);
        wgmma_bf16(acc, a_hi, b_lo);
      }
      wgmma_bf16(acc, a_hi, b_hi);
    }
  };
  // keeps a k-step's fragments alive until the wait
  auto conv_pin = [&](const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (kConvPasses == 1) {
        asm volatile("" ::"r"(a_hi[q]));
      } else {
        asm volatile("" ::"r"(a_hi[q]), "r"(a_lo[q]));
      }
    }
  };
  auto conv_step = [&](float (&acc)[32], int mg, int s, const float* bank, long long lo) {
    uint32_t a_hi[4], a_lo[4];
    conv_load(mg, s, a_hi, a_lo);
    wgmma_fence();
    conv_mma(acc, a_hi, a_lo, bank, lo);
    wgmma_commit();
    wgmma_wait();
    conv_pin(a_hi, a_lo);
  };
  // a unit's product into rows 64 * mg .. of `dst` (row stride `ld`) from
  // column `col`: column tile j holds columns 8j .. 8j+7 of the chunk; this
  // thread has 2*tig, 2*tig + 1 of rows gid and gid + 8
  auto store_conv = [&](const float (&acc)[32], int mg, float* dst, int ld, int col) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int f = mg * kUnitFrames + wrow + gid + r * 8;
        *reinterpret_cast<float2*>(dst + f * ld + col + 8 * j + 2 * tig) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  };

  // 4. first layer
  if constexpr (chunked) {
    // The chunked GEMM, chunk by chunk of 64 columns, its bank through the
    // ring a stage at a time, each chunk's product [frames, kProdLd] over
    // the staged rows (after the bank ring in the streamed layout); then
    // each sum act_a[e, j] takes the chunk's terms conv[e + t, t*h1 + j] in
    // t order, as the resident bf16 layer takes them, so every layout
    // agrees bit for bit.
    float* prod = kLayout == kStreamed ? stages + kRing * kConvStepFloats : samples;
    const int jw = min(h1, kUnitCols);  // columns of a chunk with distinct j
    for (int e = threadIdx.x >> 5; e < tile; e += blockDim.x >> 5) {
      for (int j = lane_id; j < h1; j += 32) act_a[e * mw + j] = 0.0f;
    }
    float acc[kPair][32];
#pragma unroll
    for (int p = 0; p < kPair; ++p) {
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[p][q] = 0.0f;
    }
    for (int q = 0; q < c_total; ++q) {
      const int s = q % ksteps;
      const int r = (q / ksteps) % c_rounds;
      const int cc = q / (ksteps * c_rounds) * pair_n;
      const int n_cc = min(pair_n, cchunks - cc);
      const int mg = r * groups_n + group;
      cp_async_wait<kRing - 2>();
      // stage q has landed, and every warpgroup is done with stage q - 1,
      // whose buffer is written next, and with the last chunk's sums
      __syncthreads();
      fetch_bank(q + kRing - 1);
      // a warpgroup without a frame group repeats the last one's products
      // and discards them, so that every warpgroup's wgmmas take one path
      {
        const float* stage = stages + (q % kRing) * kPair * kConvStepFloats;
        uint32_t a_hi[4], a_lo[4];
        conv_load(min(mg, fg - 1), s, a_hi, a_lo);
        // one straight sequence from the fence to the commit per case
        if (n_cc == kPair) {
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < kPair; ++p) {
            conv_mma(acc[p], a_hi, a_lo, stage + p * kStepFloats, kPair * kStepFloats);
          }
          wgmma_commit();
        } else {
          wgmma_fence();
          conv_mma(acc[0], a_hi, a_lo, stage, kPair * kStepFloats);
          wgmma_commit();
        }
        wgmma_wait();
        conv_pin(a_hi, a_lo);
      }
      if (s < ksteps - 1) continue;
#pragma unroll
      for (int p = 0; p < kPair; ++p) {
        if (p >= n_cc) break;
        if (p > 0) __syncthreads();  // the last chunk's sums have read its product
        if (mg < fg) store_conv(acc[p], mg, prod, kProdLd, 0);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
        if (r < c_rounds - 1) continue;
        __syncthreads();
        // column col0 + c is tap t = (col0 + c) / h1 of hidden unit j; the
        // chunk's other columns of the same j follow h1 further. A warp
        // takes rows e, its lanes neighbouring columns.
        const int col0 = (cc + p) * kUnitCols;
        const int warps = blockDim.x >> 5;
        for (int c = lane_id; c < jw; c += 32) {
          const int t0 = (col0 + c) / h1;
          const int j = col0 + c - t0 * h1;
          // kAddRows rows at a time, their loads ahead of their stores
          for (int e0 = threadIdx.x >> 5; e0 < tile; e0 += kAddRows * warps) {
            float a[kAddRows];
#pragma unroll
            for (int i = 0; i < kAddRows; ++i) {
              const int e = e0 + i * warps;
              a[i] = e < tile ? act_a[e * mw + j] : 0.0f;
            }
            for (int t = t0, col = c; t < T && col < kUnitCols; ++t, col += h1) {
#pragma unroll
              for (int i = 0; i < kAddRows; ++i) {
                const int e = e0 + i * warps;
                if (e < tile) a[i] += prod[(e + t) * kProdLd + col];
              }
            }
#pragma unroll
            for (int i = 0; i < kAddRows; ++i) {
              const int e = e0 + i * warps;
              if (e < tile) act_a[e * mw + j] = a[i];
            }
          }
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x >> 5; e < tile; e += blockDim.x >> 5) {
      for (int j = lane_id; j < h1; j += 32) {
        float a = act_a[e * mw + j];
        if (g.has_l2) a = a / norms[e];
        act_a[e * mw + j] = apply_transfer(a + __ldg(c1 + j), g.transfer0);
      }
    }
  } else if constexpr (kConvPasses == 0) {
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
          act_a[e * mw + j] = apply_transfer(acc + __ldg(c1 + j), g.transfer0);
        }
      }
    }
  } else if constexpr (kConvPasses > 0 && kLayout == kResident) {
    // 4. first layer under a tier in the resident layout: the whole conv
    //    filter-bank GEMM over the span, the bank in the stages; evaluation
    //    e then sums its T diagonal blocks conv[e+t, t*h1 : (t+1)*h1] in t
    //    order.
    float* conv = samples;  // [frames, conv_ld]
    const int ldc = conv_ld(g);
    const int units_c = g.frames / kUnitFrames * cchunks;
    for (int u0 = 0; u0 < units_c; u0 += groups_n) {
      const int u = u0 + group;
      if (u < units_c) {  // the same for a whole warpgroup
        const int mg = u / cchunks;
        const int ch = u - mg * cchunks;
        float acc[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
        for (int s = 0; s < ksteps; ++s) {
          conv_step(acc, mg, s, stages + (s * cchunks + ch) * kStepFloats, half);
        }
        store_conv(acc, mg, conv, ldc, ch * kUnitCols);
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < tile * h1; p += blockDim.x) {
      const int e = p / h1;
      const int j = p - e * h1;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc += conv[(e + t) * ldc + t * h1 + j];
      if (g.has_l2) acc = acc / norms[e];
      act_a[e * mw + j] = apply_transfer(acc + __ldg(c1 + j), g.transfer0);
    }
  }
  __syncthreads();
  stamp(prof, 2, t_prof);

  // 5. hidden layers
  float* a_in = act_a;
  float* a_out = act_b;
  const float* wl = mids;
  for (int l = 1; l < g.n_layers; ++l) {
    const int in_w = __ldg(layers + l - 1);
    const int out_w = __ldg(layers + l);
    const int transfer = __ldg(layers + g.n_layers + l);
    const float* bl = wl + in_w * out_w;
    for (int p = threadIdx.x; p < tile * out_w; p += blockDim.x) {
      const int e = p / out_w;
      const int o = p - e * out_w;
      float z = 0.0f;
      for (int i = 0; i < in_w; ++i) {
        z = fmaf(a_in[e * mw + i], __ldg(wl + i * out_w + o), z);
      }
      a_out[e * mw + o] = apply_transfer(z + __ldg(bl + o), transfer);
    }
    __syncthreads();
    float* tmp = a_in;
    a_in = a_out;
    a_out = tmp;
    wl = bl + out_w;
  }

  // 6. folded output affine; evaluations past the stream are not stored
  const int n_out = g.n_out;
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
inline unsigned long long* g_profile = nullptr;

// The pointers and counts of one launch.
struct Args {
  const void* x;
  int lanes;
  long long ld, n, n_evals;
  const float* cs;
  const float* w1;
  const float* w1g;
  const float* c1;
  const float* mids;
  const float* out_a;
  const float* out_c;
  float* out;
  const int* layers;
};

// Above 48 KB of dynamic shared memory a launch is refused unless the
// kernel opts in first. The opt-in is a maximum, so it is raised once per
// kernel instantiation, device and size, not on every launch.
template <typename Sample, int kDftPasses, int kConvPasses, bool kFramesIn, int kLayout>
cudaError_t opt_in(int device, size_t smem) {
  static std::mutex mutex;
  static size_t granted[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mutex);
  if (device >= 0 && device < kMaxDevices && smem <= granted[device]) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      fused_detector_kernel<Sample, kDftPasses, kConvPasses, kFramesIn, kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    granted[device] = smem;
  }
  return err;
}

template <typename Sample, int kDftPasses, int kConvPasses, bool kFramesIn, int kLayout>
int launch_layout(const Args& a, const Geometry& g, const LaneStrides& ls, const Dequant& dq,
                  size_t smem, int device, cudaStream_t stream) {
  const cudaError_t err =
      opt_in<Sample, kDftPasses, kConvPasses, kFramesIn, kLayout>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = g.frames - g.time_range + 1;
  const dim3 grid(static_cast<unsigned>((a.n_evals + tile - 1) / tile),
                  static_cast<unsigned>(a.lanes));
  fused_detector_kernel<Sample, kDftPasses, kConvPasses, kFramesIn, kLayout>
      <<<grid, 128 * n_groups(g), smem, stream>>>(
          static_cast<const Sample*>(a.x), a.ld, a.n, a.n_evals, a.cs, a.w1, a.w1g,
          a.c1, a.mids, a.out_a, a.out_c, a.out, a.layers, g, ls, dq, g_profile);
  return static_cast<int>(cudaGetLastError());
}

// The forms of every layout's launch: the float32 wire in full fp32 or
// under each tier (TIERS in kernels/fused_detector.py), from samples or
// frames, and the int16 and mu-law wires in full fp32; each fp32 form
// also with its first layer on the tensor cores.
#define SD_LAUNCH_FORMS(X, L)                                                        \
  X(float, 0, 0, false, L) X(float, 1, 1, false, L) X(float, 3, 3, false, L)          \
  X(float, 0, 3, false, L) X(float, 4, 4, false, L) X(float, 0, 0, true, L)           \
  X(float, 1, 1, true, L) X(float, 3, 3, true, L) X(float, 0, 3, true, L)             \
  X(float, 4, 4, true, L) X(int16_t, 0, 0, false, L) X(int8_t, 0, 0, false, L)         \
  X(float, 0, kConvTf32, false, L) X(float, 0, kConvTf32, true, L)                      \
  X(int16_t, 0, kConvTf32, false, L) X(int8_t, 0, kConvTf32, false, L)
#define SD_INSTANTIATE(S, D, C, F, L)                                                \
  template int launch_layout<S, D, C, F, L>(const Args&, const Geometry&,            \
                                            const LaneStrides&, const Dequant&,      \
                                            size_t, int, cudaStream_t);
#define SD_DECLARE(S, D, C, F, L) extern SD_INSTANTIATE(S, D, C, F, L)
#if !defined(SD_PART) || SD_PART == 0
SD_LAUNCH_FORMS(SD_INSTANTIATE, kResident)
#else
SD_LAUNCH_FORMS(SD_DECLARE, kResident)
#endif
#if !defined(SD_PART) || SD_PART == 1
SD_LAUNCH_FORMS(SD_INSTANTIATE, kSpan)
#else
SD_LAUNCH_FORMS(SD_DECLARE, kSpan)
#endif
#if !defined(SD_PART) || SD_PART == 2
SD_LAUNCH_FORMS(SD_INSTANTIATE, kStreamed)
#else
SD_LAUNCH_FORMS(SD_DECLARE, kStreamed)
#endif

// The layout is chosen by the wrapper (cta_choice in
// kernels/fused_detector.py): resident wherever it fits, else the span
// layout, else the streamed one.
template <typename Sample, int kDftPasses = 0, int kConvPasses = 0, bool kFramesIn = false>
int launch(const Args& a, const Geometry& g, const LaneStrides& ls, const Dequant& dq,
           size_t smem, int device, cudaStream_t stream) {
  switch (layout_of(g)) {
    case kSpan:
      return launch_layout<Sample, kDftPasses, kConvPasses, kFramesIn, kSpan>(
          a, g, ls, dq, smem, device, stream);
    case kStreamed:
      return launch_layout<Sample, kDftPasses, kConvPasses, kFramesIn, kStreamed>(
          a, g, ls, dq, smem, device, stream);
    default:
      return launch_layout<Sample, kDftPasses, kConvPasses, kFramesIn, kResident>(
          a, g, ls, dq, smem, device, stream);
  }
}

// The float32 instantiations: the full-fp32 kernel or a precision tier
// (TIERS in kernels/fused_detector.py), from samples or from frames.
template <bool kFramesIn>
int launch_float(const Args& a, const Geometry& g, const LaneStrides& ls, const Dequant& dq,
                 size_t smem, int device, cudaStream_t stream) {
  const int tier = g.dft_passes * 10 + g.conv_passes;
  switch (tier) {
    case 0:
      return launch<float, 0, 0, kFramesIn>(a, g, ls, dq, smem, device, stream);
    case kConvTf32:  // the fp32 first layer on the tensor cores
      return launch<float, 0, kConvTf32, kFramesIn>(a, g, ls, dq, smem, device, stream);
    case 11:  // fast
      return launch<float, 1, 1, kFramesIn>(a, g, ls, dq, smem, device, stream);
    case 33:  // split
      return launch<float, 3, 3, kFramesIn>(a, g, ls, dq, smem, device, stream);
    case 3:  // conv
      return launch<float, 0, 3, kFramesIn>(a, g, ls, dq, smem, device, stream);
    case 44:  // split4
      return launch<float, 4, 4, kFramesIn>(a, g, ls, dq, smem, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

inline Geometry make_geometry(int window, int hop, int gap, int bins, int time_range,
                       int scaling, int has_l2, int frames, int max_width, int h1,
                       int dft_passes, int conv_passes, int frames_input, int col_group) {
  Geometry g = {};
  g.window = window;
  g.hop = hop;
  g.gap = gap;
  g.bins = bins;
  g.time_range = time_range;
  g.scaling = scaling;
  g.has_l2 = has_l2;
  g.frames = frames;
  g.max_width = max_width;
  g.h1 = h1;
  g.dft_passes = dft_passes;
  g.conv_passes = conv_passes;
  g.frames_input = frames_input;
  g.col_group = col_group;
  return g;
}

}  // namespace sd_fused

using namespace sd_fused;

#if !defined(SD_PART) || SD_PART == 0
extern "C" {

// Dynamic shared memory, in bytes, that one CTA of the kernel needs when it
// transforms `frames` frames with the given arithmetic and input form, in
// the resident layout (col_group 0), the span layout (-n) or the streamed
// one (n), over n chunks of C a pass.
long long sd_fused_detector_smem_bytes(int window, int hop, int gap, int bins,
                                       int time_range, int frames, int max_width,
                                       int h1, int dft_passes, int conv_passes,
                                       int frames_input, int col_group) {
  const Geometry g = make_geometry(window, hop, gap, bins, time_range, 0, 0, frames,
                                   max_width, h1, dft_passes, conv_passes, frames_input,
                                   col_group);
  return smem_floats(g) * (long long)sizeof(float);
}

// Shape of the split C the kernel reads. TF32 (dft_passes 0): [blocks, 2,
// steps, chunks, 8, 2, 8, 4] floats = blocks of kBlockRows rows x (hi, lo) x
// k-steps of 8 rows x chunks of 64 columns x blocks of 8 columns x halves of
// a k-step x column x row: element (row r, column c) of half h lies at block
// r / 16, h, step (r % 16) / 8, chunk c / 64, (c % 64) / 8, (r % 8) / 4, c %
// 8, r % 4. bf16: [blocks, 2, steps, chunks, 8, 2, 8, 8] bf16 with blocks of
// kBf16BlockRows rows and k-steps of 16, each k-step's rows in the order of
// pack_bf16_step (tile_dft_matrix_bf16 in kernels/fused_detector.py).
int sd_fused_detector_c_blocks(int window, int dft_passes) {
  const int rows = dft_passes ? kBf16BlockRows : kBlockRows;
  return (window + rows - 1) / rows;
}
int sd_fused_detector_c_chunks(int bins) {
  return (2 * kGroupBins * ((bins + kGroupBins - 1) / kGroupBins) + kUnitCols - 1) /
         kUnitCols;
}
// Floats (4-byte words) of one net's tiled bf16 conv filter bank, both
// halves: [2, steps, chunks, 8, 2, 8, 8] bf16 over ceil(bins / 16) k-steps
// and ceil(time_range * h1 / 64) chunks (tile_conv_bank_bf16).
long long sd_fused_detector_conv_bank_floats(int bins, int time_range, int h1) {
  Geometry g = make_geometry(0, 1, 0, bins, time_range, 0, 0, 0, 0, h1, 0, 1, 0, 0);
  return 2 * conv_half_floats(g);
}
// Floats of one net's tiled TF32 conv filter bank, both halves, for the
// fp32 first layer on the tensor cores (conv_passes kConvTf32): [2, steps,
// chunks, 8, 2, 8, 4] over ceil(bins / 8) k-steps, each k-step of each
// chunk in the layout of one k-step of C (tile_conv_bank_tf32).
long long sd_fused_detector_tf32_bank_floats(int bins, int time_range, int h1) {
  Geometry g = make_geometry(0, 1, 0, bins, time_range, 0, 0, 0, 0, h1, 0, kConvTf32, 0, 0);
  return 2 * conv_half_floats(g);
}

const char* sd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Device buffer of 8 unsigned 64-bit counters that every later launch adds
// its CTAs' clock64() cycles to, or null to stop: [0] staging, [1] the band
// DFT's epilogue, [2] first layer, [3] the rest, [4] waiting for a block of
// C, [5] the mma steps on it, [6] the streamed layout's copies of the next
// block of A and C ([1] + [4] + [5] + [6] is the band DFT). For
// measurements only.
void sd_fused_detector_set_profile(void* counters) {
  g_profile = static_cast<unsigned long long*>(counters);
}

// Launches the kernel on `stream` (device `device`) for `lanes` streams of
// `n` samples each, lane l at x + l * ld, as wire type `wire` (a Wire
// code); with `frames_input` 1 a lane is instead a row-major [n, window]
// float32 matrix of frames. All pointers are device pointers except
// `widths` and `transfers`, host arrays of n_layers ints; `layers` is the
// same two arrays on the device, [2, n_layers] int32 (any depth). `cs` is C padded
// with zeros, its columns in tiles of 8 (re of bins 8j..8j+7, then their
// im), split into TF32 halves (dft_passes 0) or bf16 halves (1, 3 or 4
// products) and laid out as sd_fused_detector_c_blocks / _c_chunks
// describe. `w1g` is the tiled bf16 conv filter bank
// (sd_fused_detector_conv_bank_floats per net) when conv_passes is 1, 3 or
// 4, the TF32 one (sd_fused_detector_tf32_bank_floats) when it is
// kConvTf32 (-3: the fp32 first layer on the tensor cores), else unused.
// The tiers take the float32 wire only. `frames` is the number of frames
// one CTA transforms, a multiple of 64 above time_range - 1; it serves
// frames - time_range + 1 evaluations. `col_group` 0 takes the
// resident layout, -1 .. -c_chunks the span layout and 1 .. c_chunks the
// streamed one, with that many chunks of C a pass over k. `per_lane_nets` is 0
// when every lane shares one net and 1 when the net operands hold one net
// per lane, stacked. Returns cudaGetLastError() after the launch: 0 when
// the launch was taken.
int sd_fused_detector(const void* x, int wire, int lanes, long long ld,
                      long long n, long long n_evals, const void* cs,
                      const float* w1, const void* w1g, const float* c1,
                      const float* mids, const float* out_a, const float* out_c,
                      float* out, int per_lane_nets, int window, int hop, int gap,
                      int bins, int time_range, int scaling, int has_l2,
                      int frames, int dft_passes, int conv_passes,
                      int frames_input, int col_group, int n_layers, const int* widths,
                      const int* transfers, const int* layers, float dq_scale,
                      float dq_ln1mu, float dq_inv_mu, int device, void* stream) {
  const bool plain = dft_passes == 0 && (conv_passes == 0 || conv_passes == kConvTf32) &&
                     !frames_input;
  const int chunks = sd_fused_detector_c_chunks(bins);
  if (n_layers < 1 || layers == nullptr || n_evals < 1 || lanes < 1 ||
      lanes > 65535 || n < 0 || ld < (frames_input ? n * window : n) ||
      window < 1 || hop < 1 || gap < 0 || bins < 1 || time_range < 1 ||
      frames < kUnitFrames || frames % kUnitFrames != 0 || frames < time_range ||
      col_group < -chunks || col_group > chunks ||
      (conv_passes < 0 && conv_passes != kConvTf32) ||
      (!plain && wire != kFloat32) || (conv_passes && w1g == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile = frames - time_range + 1;
  if ((n_evals + tile - 1) / tile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int max_width = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (widths[l] > max_width) max_width = widths[l];
  }
  Geometry g = make_geometry(window, hop, gap, bins, time_range, scaling, has_l2, frames,
                             max_width, widths[0], dft_passes, conv_passes, frames_input,
                             col_group);
  g.n_layers = n_layers;
  g.n_out = widths[n_layers - 1];
  g.transfer0 = transfers[0];
  const size_t smem = static_cast<size_t>(smem_floats(g)) * sizeof(float);

  LaneStrides s = {0, 0, 0, 0, 0};
  if (per_lane_nets) {
    s.w1 = static_cast<long long>(time_range) * bins * widths[0];
    s.c1 = widths[0];
    for (int l = 1; l < n_layers; ++l) {
      s.mids += static_cast<long long>(widths[l - 1]) * widths[l] + widths[l];
    }
    s.out = widths[n_layers - 1];
    s.w1g = conv_passes ? 2 * conv_half_floats(g) : 0;
  }
  const Dequant dq = {dq_scale, dq_ln1mu, dq_inv_mu};
  const Args a = {x, lanes, ld, n, n_evals, static_cast<const float*>(cs), w1,
                  static_cast<const float*>(w1g), c1, mids, out_a, out_c, out, layers};

  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (frames_input) return launch_float<true>(a, g, s, dq, smem, device, st);
  switch (wire) {
    case kFloat32:
      return launch_float<false>(a, g, s, dq, smem, device, st);
    case kInt16:
      return conv_passes == kConvTf32
                 ? launch<int16_t, 0, kConvTf32>(a, g, s, dq, smem, device, st)
                 : launch<int16_t>(a, g, s, dq, smem, device, st);
    case kMulaw8:
      return conv_passes == kConvTf32
                 ? launch<int8_t, 0, kConvTf32>(a, g, s, dq, smem, device, st)
                 : launch<int8_t>(a, g, s, dq, smem, device, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
#endif
