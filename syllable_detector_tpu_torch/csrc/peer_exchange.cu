// Gradient exchange between cards for Hopper (sm_90a), plain C interface.
//
// Not a port of a TPU kernel: the JAX trainer reaches no pl.pallas_call.
// It is the counterpart of the pmean inside the JAX trainer's data-parallel
// epoch (syllable_detector_tpu/training/trainer.py, _make_restart_epoch:
// jax.shard_map of one lax.scan whose step takes lax.pmean of the gradients
// and losses). The port's data mesh across cards runs each card's whole
// epoch as one CUDA graph (training/trainer.py, _CardsEpochGraph), so the
// exchange has to happen inside the graph, card to card, with no host call.
//
// It is an all-gather, not a reduce. Each card holds a buffer of every
// shard's row (the shard's losses, then its gradients, `width` floats) in
// two slots, [2, shards, width]. A step on a card is:
//   1. its shards' rows computed into a local [its shards, width] buffer;
//   2. sd_peer_push: one CTA a destination card stores those rows into the
//      rows of their shards in the step's slot of that card's buffer,
//      through peer pointers (UVA, peer access enabled); after a CTA
//      barrier one thread fences at system scope and stores, as a release,
//      one flag for (this source, that card):
//      the step number + 1. The flag only grows, so it is never reset, and
//      the graph's replays need no host work between them;
//   3. sd_peer_wait: spins on this card's flag of every source with an
//      acquire load at system scope until it reaches the step, then copies
//      the step's slot into a fixed [shards, width] buffer, which the
//      update (in PyTorch, on the card) sums in shard order.
// Every card then sums the same bytes in the same order with the same
// kernels, so the replicas of the parameters stay equal bit for bit, and
// equal to the per-step route that sums on card 0 (an NCCL ring would sum
// in another order).
//
// Two slots suffice. A card pushes step s + 1 only after its wait of step
// s, which needs every card's push of step s. So a source is at most one
// step ahead of any card: while a card copies out step s, a source may
// write step s + 1, into the other slot, but step s + 2, which would write
// this slot again, needs this card's push of step s + 1, which this card
// issues (stream order) only after its copy of step s has finished.
//
// A wait that does not see its flags within `timeout_ns` (of %globaltimer:
// clock64 counts SM cycles, whose rate moves with the clock) stores the
// late source + 1 into an error word and returns; later waits on that
// card return at once while the word is set. The wrapper reads the words
// after a call and raises: a hang would eat a run's time limit, and a
// silent exit would hide a wrong result.
//
// What bounds it on the card: latency, not bytes. At the train CLI's
// defaults a row is 4680 floats (18.7 KB); a card sends its rows to every
// card, well under a microsecond of NVLink's bytes. A step pays a store's
// trip over NVLink, the system fence, the flag's trip and the poll, and
// the copy-out of [shards, width] from the card's own memory. One CTA a
// destination keeps the flag's ordering to one CTA barrier; the copy-out
// uses float4 loads that bypass L1 (__ldcv), so no line cached before the
// peers' stores is read.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCards = 8;
constexpr int kPushThreads = 512;
constexpr int kWaitThreads = 256;
constexpr int kMaxWaitBlocks = 32;

struct Peers {
  float* slots[kMaxCards];               // each card's [2, shards, width]
  unsigned long long* flags[kMaxCards];  // each card's [cards], by source
};

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// grid: one CTA a destination card. The step is *base + offset.
template <bool kVec>
__global__ void __launch_bounds__(kPushThreads)
    push_kernel(const float* __restrict__ rows, const int* __restrict__ shard_of, int n_rows,
                int shards, int width, Peers peers, int source, const long long* __restrict__ base,
                int offset) {
  const int dest = blockIdx.x;
  const unsigned long long step = static_cast<unsigned long long>(*base + offset);
  float* slot = peers.slots[dest] + static_cast<size_t>(step & 1ULL) * shards * width;
  for (int r = 0; r < n_rows; ++r) {
    const float* src = rows + static_cast<size_t>(r) * width;
    float* dst = slot + static_cast<size_t>(shard_of[r]) * width;
    if (kVec) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < width / 4; i += blockDim.x) d4[i] = s4[i];
    } else {
      for (int i = threadIdx.x; i < width; i += blockDim.x) dst[i] = src[i];
    }
  }
  // the CTA's stores ordered before thread 0's fence at system scope (the
  // barrier), then the flag: a release, cumulative over what the barrier
  // ordered before it
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    store_release_sys(peers.flags[dest] + source, step + 1);
  }
}

// Every CTA polls the flags (a thread a source), then copies its share of
// the step's slot into `ready` ([count] floats).
template <bool kVec>
__global__ void __launch_bounds__(kWaitThreads)
    wait_kernel(const unsigned long long* flags, int cards, const float* slots,
                float* __restrict__ ready, int count, const long long* __restrict__ base,
                int offset, int* error, long long timeout_ns) {
  const unsigned long long step = static_cast<unsigned long long>(*base + offset);
  if (threadIdx.x < cards && *reinterpret_cast<volatile int*>(error) == 0) {
    const unsigned long long start = global_ns();
    while (load_acquire_sys(flags + threadIdx.x) <= step) {
      if (global_ns() - start > static_cast<unsigned long long>(timeout_ns)) {
        atomicCAS(error, 0, static_cast<int>(threadIdx.x) + 1);
        break;
      }
      __nanosleep(32);
    }
  }
  __syncthreads();
  const float* slot = slots + static_cast<size_t>(step & 1ULL) * count;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(slot);
    float4* r4 = reinterpret_cast<float4*>(ready);
    for (int i = first; i < count / 4; i += stride) r4[i] = __ldcv(s4 + i);
  } else {
    for (int i = first; i < count; i += stride) ready[i] = __ldcv(slot + i);
  }
}

// Makes `device` current for the launch and gives the caller's card back.
struct DeviceScope {
  int previous = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&previous);
    if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    int now = -1;
    if (previous >= 0 && cudaGetDevice(&now) == cudaSuccess && now != previous) {
      cudaSetDevice(previous);
    }
  }
};

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

const char* sd_peer_exchange_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sd_peer_max_cards() { return kMaxCards; }

// Lets `device`'s kernels read and write `peer`'s memory. Returns
// cudaErrorPeerAccessUnsupported where the pair cannot (no fallback: the
// caller raises), 0 where access is on, also where it was on before (as
// PyTorch turns it on at its first copy between the two).
int sd_peer_enable(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: it is no fault here
    err = cudaSuccess;
  }
  return static_cast<int>(err);
}

// Pushes `rows` [n_rows, width] float32 (on `device`) into the rows
// `shard_of` [n_rows] int32 of the step's slot of each of the `cards`
// buffers `slots` [2, shards, width] float32, and raises this source's
// flag in each of `flags` [cards] int64 to the step + 1; the step is
// *base + offset (base: one int64 on `device`). `slots` and `flags` are
// host arrays of device pointers, card by card. Launches on `stream`;
// returns cudaErrorInvalidValue for arguments it cannot take, else
// cudaGetLastError() after the launch.
int sd_peer_push(const float* rows, const int* shard_of, int n_rows, int shards, int width,
                 float* const* slots, unsigned long long* const* flags, int cards, int source,
                 const long long* base, int offset, int device, void* stream) {
  if (n_rows < 1 || n_rows > shards || width < 1 || cards < 1 || cards > kMaxCards ||
      source < 0 || source >= cards || offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Peers peers;
  bool vec = width % 4 == 0 && aligned16(rows);
  for (int c = 0; c < kMaxCards; ++c) {
    peers.slots[c] = c < cards ? slots[c] : nullptr;
    peers.flags[c] = c < cards ? flags[c] : nullptr;
    if (c < cards) vec = vec && aligned16(slots[c]);
  }
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    push_kernel<true><<<cards, kPushThreads, 0, st>>>(rows, shard_of, n_rows, shards, width,
                                                       peers, source, base, offset);
  } else {
    push_kernel<false><<<cards, kPushThreads, 0, st>>>(rows, shard_of, n_rows, shards, width,
                                                        peers, source, base, offset);
  }
  return static_cast<int>(cudaGetLastError());
}

// Waits until each of `flags` [cards] int64 (on `device`) exceeds the step
// (*base + offset), then copies the step's slot of `slots` [2, count]
// float32 into `ready` [count] float32. A wait past `timeout_ns` stores
// the late source + 1 into `error` (one int32) and copies what is there;
// while `error` is set, the wait does not poll. Launches on `stream`;
// returns cudaErrorInvalidValue for arguments it cannot take, else
// cudaGetLastError() after the launch.
int sd_peer_wait(const unsigned long long* flags, int cards, const float* slots, float* ready,
                 int count, const long long* base, int offset, int* error, long long timeout_ns,
                 int device, void* stream) {
  if (cards < 1 || cards > kMaxCards || count < 1 || offset < 0 || timeout_ns < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = count % 4 == 0 && aligned16(slots) && aligned16(ready);
  const int items = vec ? count / 4 : count;
  int blocks = (items + kWaitThreads - 1) / kWaitThreads;
  if (blocks > kMaxWaitBlocks) blocks = kMaxWaitBlocks;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    wait_kernel<true><<<blocks, kWaitThreads, 0, st>>>(flags, cards, slots, ready, count, base,
                                                        offset, error, timeout_ns);
  } else {
    wait_kernel<false><<<blocks, kWaitThreads, 0, st>>>(flags, cards, slots, ready, count, base,
                                                         offset, error, timeout_ns);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
