// Hand-written Hopper kernels of the GossipSub hot loop (sm_90a).
//
// Two kernels replace the JAX package's two Pallas TPU kernels
// (go_libp2p_pubsub_tpu/ops/pallas_gossip.py):
//
//   K1 gossip_propagate  <- _propagate_kernel  (one eager-push round)
//   K2 gossip_exchange   <- _exchange_kernel   (heartbeat IHAVE/IWANT)
//
// Both use one warp per peer with lane s = neighbor slot s (K <= 32).  A
// message window is W 32-bit words; each lane walks its slot's W words
// in order, and everything that crosses slots (the first delivering or
// first advertising slot of each message bit, the OR over slots) is a
// warp shuffle scan or reduction over one word at a time.  The neighbor
// gather happens inside the kernel: the [N, K, W] cube the TPU design
// writes to and reads back from device memory never exists.
//
// Both kernels are bound by device-memory bytes, not operations: per
// peer they move K neighbor ids and a few [K] byte masks in, K float
// counters out, and W words of a small table that stays in L2.  The
// layout keeps every [N, K] access coalesced (a warp reads or writes one
// contiguous row of K elements).
//
// Plain C interface for ctypes: each entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

// Inclusive prefix-OR across the 32 lanes of a warp (Hillis-Steele).
__device__ __forceinline__ uint32_t warp_prefix_or(uint32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x |= y;
  }
  return x;
}

// K1: one eager-push round.  Inputs are the plain version's
// (gossip_packed.propagate_packed): the per-edge sender words are
// fresh[nbrs[i, s]] (or fresh_src[i, s] under per-edge delay), masked by
// mesh & edge_live.
__global__ void propagate_kernel(
    const uint8_t* __restrict__ mesh,        // [N, K]
    const uint8_t* __restrict__ edge_live,   // [N, K]
    const int32_t* __restrict__ nbrs,        // [N, K]
    const uint8_t* __restrict__ alive,       // [N]
    const uint32_t* __restrict__ have,       // [N, W]
    const uint32_t* __restrict__ fresh,      // [N, W]
    const uint32_t* __restrict__ fresh_src,  // [N, K, W] or null
    const uint32_t* __restrict__ idw,        // [N, W] or null (IDONTWANT off)
    const uint32_t* __restrict__ valid,      // [W]
    uint32_t* __restrict__ have_o,           // [N, W]
    uint32_t* __restrict__ fresh_o,          // [N, W]
    uint32_t* __restrict__ new_o,            // [N, W]
    float* __restrict__ fmd,                 // [N, K]
    float* __restrict__ mmd,                 // [N, K]
    float* __restrict__ inv,                 // [N, K]
    int n, int k, int w) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const bool in = lane < k;
  const long long e = i * k + lane;
  const bool ok = in && mesh[e] && edge_live[e];
  long long j = 0;
  if (ok && fresh_src == nullptr) {
    j = min(max(nbrs[e], 0), n - 1);
  }
  const uint32_t alive_m = alive[i] ? kFull : 0u;
  int c_fmd = 0, c_inv = 0, c_mmd = 0;
  for (int ww = 0; ww < w; ++ww) {
    uint32_t x = 0;
    if (ok) x = fresh_src ? fresh_src[e * w + ww] : fresh[j * w + ww];
    const uint32_t p = warp_prefix_or(x, lane);
    const uint32_t arrived = __shfl_sync(kFull, p, 31);
    uint32_t before = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) before = 0;
    const uint32_t hv = have[i * w + ww];
    const uint32_t vd = valid[ww];
    const uint32_t nw = arrived & ~hv & alive_m;
    const uint32_t newly = x & ~before & nw;
    c_fmd += __popc(newly & vd);
    c_inv += __popc(newly & ~vd);
    const uint32_t counted = idw ? (x & ~idw[i * w + ww]) : x;
    c_mmd += __popc(counted & vd);
    if (lane == 0) {
      have_o[i * w + ww] = hv | (nw & vd);
      fresh_o[i * w + ww] = nw & vd;
      new_o[i * w + ww] = nw;
    }
  }
  if (in) {
    fmd[e] = (float)c_fmd;
    mmd[e] = (float)c_mmd;
    inv[e] = (float)c_inv;
  }
}

// K2: IHAVE cap + IWANT select over slots already in the receiver's
// random priority order (gossip_packed.exchange_select).  Lane s reads
// its advertiser's words rows[jidx_p[i, s]] when that advertiser chose
// this receiver, caps them at max_ihave ids (word-granular running
// popcount), drops ids already held or from unaccepted advertisers,
// keeps the first advertiser of each id (exclusive prefix-OR over lanes),
// caps the asks at max_iwant, and ORs the served asks over lanes.
__global__ void exchange_kernel(
    const int32_t* __restrict__ jidx_p,      // [N, K]
    const uint8_t* __restrict__ adv_ok_p,    // [N, K]
    const uint8_t* __restrict__ accept_p,    // [N, K]
    const uint8_t* __restrict__ serve_p,     // [N, K]
    const uint32_t* __restrict__ rows,       // [N, W]
    const uint32_t* __restrict__ have_dedup, // [N, W]
    const uint8_t* __restrict__ alive,       // [N]
    uint32_t* __restrict__ pend,             // [N, W]
    float* __restrict__ broken_p,            // [N, K]
    int n, int k, int w, int max_ihave, int max_iwant) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const bool in = lane < k;
  const long long e = i * k + lane;
  const bool adv_ok = in && adv_ok_p[e];
  const uint32_t accept_m = (in && accept_p[e]) ? kFull : 0u;
  const bool serve = in && serve_p[e];
  long long j = 0;
  if (adv_ok) j = min(max(jidx_p[e], 0), n - 1);
  const uint32_t alive_m = alive[i] ? kFull : 0u;
  int c_ihave = 0, c_iwant = 0, c_broken = 0;
  for (int ww = 0; ww < w; ++ww) {
    uint32_t a = adv_ok ? rows[j * w + ww] : 0u;
    c_ihave += __popc(a);
    if (c_ihave > max_ihave) a = 0u;
    const uint32_t want = a & ~have_dedup[i * w + ww] & accept_m;
    const uint32_t p = warp_prefix_or(want, lane);
    uint32_t before = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) before = 0;
    const uint32_t first = want & ~before;
    c_iwant += __popc(first);
    const uint32_t asked = (c_iwant <= max_iwant) ? first : 0u;
    if (!serve) c_broken += __popc(asked);
    const uint32_t served = __reduce_or_sync(kFull, serve ? asked : 0u);
    if (lane == 0) pend[i * w + ww] = served & alive_m;
  }
  if (in) broken_p[e] = (float)c_broken;
}

inline dim3 grid_for(int n) {
  return dim3((unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

}  // namespace

extern "C" int gossip_propagate(
    const void* mesh, const void* edge_live, const void* nbrs,
    const void* alive, const void* have, const void* fresh,
    const void* fresh_src, const void* idw, const void* valid,
    void* have_o, void* fresh_o, void* new_o,
    void* fmd, void* mmd, void* inv,
    int n, int k, int w, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  propagate_kernel<<<grid_for(n), kWarpsPerBlock * 32, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)mesh, (const uint8_t*)edge_live, (const int32_t*)nbrs,
      (const uint8_t*)alive, (const uint32_t*)have, (const uint32_t*)fresh,
      (const uint32_t*)fresh_src, (const uint32_t*)idw,
      (const uint32_t*)valid, (uint32_t*)have_o, (uint32_t*)fresh_o,
      (uint32_t*)new_o, (float*)fmd, (float*)mmd, (float*)inv, n, k, w);
  return (int)cudaGetLastError();
}

extern "C" int gossip_exchange(
    const void* jidx_p, const void* adv_ok_p, const void* accept_p,
    const void* serve_p, const void* rows, const void* have_dedup,
    const void* alive, void* pend, void* broken_p,
    int n, int k, int w, int max_ihave, int max_iwant, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  exchange_kernel<<<grid_for(n), kWarpsPerBlock * 32, 0,
                    (cudaStream_t)stream>>>(
      (const int32_t*)jidx_p, (const uint8_t*)adv_ok_p,
      (const uint8_t*)accept_p, (const uint8_t*)serve_p,
      (const uint32_t*)rows, (const uint32_t*)have_dedup,
      (const uint8_t*)alive, (uint32_t*)pend, (float*)broken_p,
      n, k, w, max_ihave, max_iwant);
  return (int)cudaGetLastError();
}
