// Hand-written Hopper kernels of the GossipSub hot loop (sm_90a).
//
// Two kernels replace the JAX package's two Pallas TPU kernels
// (go_libp2p_pubsub_tpu/ops/pallas_gossip.py):
//
//   K1 gossip_propagate  <- _propagate_kernel  (one eager-push round)
//   K2 gossip_exchange   <- _exchange_kernel   (heartbeat IHAVE/IWANT)
//
// Both are bound by device-memory bytes: per peer they read K neighbor ids
// and a few [K] byte masks, write K float counters (the bulk of the
// bytes), and gather W words a delivering slot from a small table (1.6 MB
// at the headline) that stays in L2.
//
// One thread owns one peer.  It packs its [K] byte masks into a bit mask of
// slots (K <= 32) and walks only the slots that deliver (K1) or advertise
// (K2), in slot order: "the first slot that delivered a message bit" is a
// running OR over the slots walked so far.  A neighbor's W words are one
// vector load (a 16-byte gather at W = 4), issued a batch of slots at a
// time so the batch's L2 round trips overlap, and W is a template
// parameter so a row's words live in registers.  Only about a quarter of
// the slots deliver, so this does a quarter of the work of a warp-per-peer
// design with lane = slot, which spends the same instructions on every
// slot and a shuffle scan across lanes per word (PERF.md has the
// measurements of both designs).
//
// Warps work on their own: a warp takes a tile of 32 peers (lane = peer),
// starts copying the tile's [32, K] neighbor ids into its shared memory
// with cp.async while each lane loads its own masks and W-word rows, then
// walks and drains its counts.  A thread's [K] float counters would be a
// strided row store, so the warp keeps them in shared memory ([32, K]
// 8-bit counts at W <= 4; only the walked slots are written, the rest stay
// 0) and writes the tile's rows out as coalesced 16-byte float stores,
// zeroing them for the next tile.  No barrier couples the warps of a block.
// The grid is persistent: at most as many blocks as the SMs hold at once
// (gossip_launch_shape), whose warps walk every (grid * warps)-th tile (the
// caller sizes it; at the headline every warp has one tile).
//
// W in {1, 2, 4, 8} have their own instantiation; any other W takes the
// generic one (W = 0: runtime w, word by word, counters and per-slot cap
// state in shared memory).  The caller (ops/cuda_gossip.py) picks the
// instantiation (`variant`) and the grid; the generic one also serves a
// W-word table whose address is not aligned to the vector.
//
// Plain C interface for ctypes: each entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = 32 * kWarps;
// Registers are capped so that this many blocks of the W <= 4
// instantiations fit on an SM (gossip_launch_shape reports what does fit).
constexpr int kMinBlocks = 6;
constexpr int kMaxSlots = 32;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The warp starts copying `count` int32 from device into shared memory:
// 16-byte cp.async chunks where the source allows it, words otherwise.
// Complete with cp_async_wait_all() and __syncwarp().
__device__ __forceinline__ void warp_stage_words(int32_t* dst,
                                                 const int32_t* src,
                                                 int count, int lane) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = count >> 2;
    for (int c = lane; c < n16; c += 32) cp_async16(dst + 4 * c, src + 4 * c);
    head = n16 << 2;
  }
  for (int e = head + lane; e < count; e += 32) dst[e] = __ldg(src + e);
}

// Gathers a lane has in flight at once, G rows of W words: as many as the
// registers allow without spilling (K1 keeps more per slot than K2).
template <int V>
constexpr int kBatchK1 = V >= 8 ? 2 : (V >= 4 ? 4 : 8);
template <int V>
constexpr int kBatchK2 = V >= 8 ? 4 : 8;

// ---- slot masks -------------------------------------------------------------

// 0x01 in each byte of v that is nonzero, 0x00 elsewhere.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  return ((((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) >> 7) & 0x01010101u;
}

// Four 0/1 bytes -> four bits (byte b -> bit b).
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  return (v * 0x01020408u) >> 24;
}

// Bit s (s < k) set where a[s] and b[s] are both nonzero: 16-byte loads
// where the rows allow it, bytes otherwise.
__device__ __forceinline__ uint32_t slot_bits(const uint8_t* __restrict__ a,
                                              const uint8_t* __restrict__ b,
                                              int k) {
  uint32_t m = 0;
  if ((k & 15) == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
       15) == 0) {
    for (int s0 = 0; s0 < k; s0 += 16) {
      const uint4 va = __ldg(reinterpret_cast<const uint4*>(a + s0));
      const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b + s0));
      const uint32_t bits =
          pack4(nonzero_bytes(va.x) & nonzero_bytes(vb.x)) |
          pack4(nonzero_bytes(va.y) & nonzero_bytes(vb.y)) << 4 |
          pack4(nonzero_bytes(va.z) & nonzero_bytes(vb.z)) << 8 |
          pack4(nonzero_bytes(va.w) & nonzero_bytes(vb.w)) << 12;
      m |= bits << s0;
    }
  } else {
    for (int s = 0; s < k; ++s)
      if (__ldg(a + s) && __ldg(b + s)) m |= 1u << s;
  }
  return m;
}

// ---- W-word rows as vectors -------------------------------------------------

// V consecutive words from device memory (read-only path), one vector load
// per 16 bytes.  The address is aligned to min(16, 4V) bytes (the caller
// takes the generic instantiation otherwise).
template <int V>
__device__ __forceinline__ void load_row(uint32_t (&r)[V],
                                         const uint32_t* __restrict__ p) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + q);
      r[4 * q] = t.x; r[4 * q + 1] = t.y; r[4 * q + 2] = t.z;
      r[4 * q + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = t.x; r[1] = t.y;
  } else {
    static_assert(V == 1, "rows are 1, 2 or a multiple of 4 words");
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_row(uint32_t* p, const uint32_t (&r)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      __stcs(reinterpret_cast<uint4*>(p) + q,
             make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(r[0], r[1]));
  } else {
    __stcs(p, r[0]);
  }
}

// ---- the warp's shared memory ------------------------------------------------

// Per-slot counts in shared memory: 8 bits up to W = 4 and 16 bits at
// W = 8 (a count is at most 32 W), 32 bits for the generic instantiation.
template <int W>
using Count = std::conditional_t<
    (W == 0), uint32_t, std::conditional_t<(W <= 4), uint8_t, uint16_t>>;

// A warp's region: its 32 peers' neighbor ids ([32, K] int32) and
// `planes` [32, K] count planes.
template <int W>
__host__ __device__ constexpr int plane_bytes(int k) {
  return align16(32 * k * (int)sizeof(Count<W>));
}
template <int W>
__host__ __device__ constexpr int warp_bytes(int k, int planes) {
  return align16(32 * k * 4) + planes * plane_bytes<W>(k);
}
// K1 keeps three count planes; K2 one (three for the generic W).
template <int W>
constexpr int propagate_smem(int k) { return kWarps * warp_bytes<W>(k, 3); }
template <int W>
constexpr int exchange_smem(int k) {
  return kWarps * warp_bytes<W>(k, W > 0 ? 1 : 3);
}

// Write the first `count` counts of a plane as floats to dst (coalesced,
// 16 bytes a lane where dst allows it) and zero them for the next tile.
// Outputs are stored evict-first (st.global.cs): K1 writes 43 MB at the
// headline, most of the 50 MB L2, and normal stores leave it full of
// dirty lines whose write-back lands on the next launch.
template <typename C>
__device__ __forceinline__ void warp_drain(C* plane, float* __restrict__ dst,
                                           int count, int lane) {
  const int n4 = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 ? count >> 2 : 0;
  for (int c = lane; c < n4; c += 32) {
    float4 f;
    if constexpr (sizeof(C) == 1) {
      const uint32_t t = reinterpret_cast<const uint32_t*>(plane)[c];
      reinterpret_cast<uint32_t*>(plane)[c] = 0u;
      f = make_float4((float)(t & 0xff), (float)((t >> 8) & 0xff),
                      (float)((t >> 16) & 0xff), (float)(t >> 24));
    } else if constexpr (sizeof(C) == 2) {
      const uint2 t = reinterpret_cast<const uint2*>(plane)[c];
      reinterpret_cast<uint2*>(plane)[c] = make_uint2(0u, 0u);
      f = make_float4((float)(t.x & 0xffff), (float)(t.x >> 16),
                      (float)(t.y & 0xffff), (float)(t.y >> 16));
    } else {
      const uint4 t = reinterpret_cast<const uint4*>(plane)[c];
      reinterpret_cast<uint4*>(plane)[c] = make_uint4(0u, 0u, 0u, 0u);
      f = make_float4((float)t.x, (float)t.y, (float)t.z, (float)t.w);
    }
    __stcs(reinterpret_cast<float4*>(dst) + c, f);
  }
  for (int e = 4 * n4 + lane; e < count; e += 32) {
    __stcs(dst + e, (float)plane[e]);
    plane[e] = 0;
  }
}

__device__ __forceinline__ void zero_shared(uint8_t* p, int bytes) {
  for (int c = threadIdx.x; c < bytes / 16; c += kThreads)
    reinterpret_cast<uint4*>(p)[c] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ int clamp_peer(int32_t j, int n) {
  return min(max(j, 0), n - 1);
}

// ---- K1 ---------------------------------------------------------------------

// One eager-push round.  Inputs are the plain version's
// (gossip_packed.propagate_packed): the per-edge sender words are
// fresh[nbrs[i, s]] (or fresh_src[i, s] under per-edge delay), masked by
// mesh & edge_live.  For each message bit the lowest delivering slot is
// credited: newly = x & ~before & ~have & alive, where `before` is the OR
// of the slots walked so far; at the end `before` is what arrived.
template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
propagate_kernel(
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
    int n, int k, int w_rt) {
  using C = Count<W>;
  constexpr int V = W > 0 ? W : 1;
  const int w = W > 0 ? W : w_rt;
  const int lane = threadIdx.x & 31;
  extern __shared__ __align__(16) uint8_t smem[];
  zero_shared(smem, kWarps * warp_bytes<W>(k, 3));
  __syncthreads();
  uint8_t* mine = smem + (threadIdx.x >> 5) * warp_bytes<W>(k, 3);
  int32_t* ids = reinterpret_cast<int32_t*>(mine);
  C* c_fmd = reinterpret_cast<C*>(mine + align16(32 * k * 4));
  C* c_mmd = c_fmd + plane_bytes<W>(k) / sizeof(C);
  C* c_inv = c_mmd + plane_bytes<W>(k) / sizeof(C);

  uint32_t vd[V];
  if constexpr (W > 0) load_row<V>(vd, valid);

  // Warp tiles of 32 peers, lane = peer; the warps of the grid walk them.
  const int ntiles = (n + 31) / 32;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < ntiles;
       t += gridDim.x * kWarps) {
    const long long p0 = (long long)t * 32;
    const int rows = min(32, n - (int)p0);
    if (!fresh_src) warp_stage_words(ids, nbrs + p0 * k, rows * k, lane);
    // The lane's own rows load while the neighbor ids arrive.
    const bool in = lane < rows;
    const long long i = p0 + lane;
    const int e0 = lane * k;
    uint32_t ok = 0u, alive_m = 0u, hv[V], iw[V];
    if (in) {
      alive_m = alive[i] ? 0xffffffffu : 0u;
      ok = slot_bits(mesh + i * k, edge_live + i * k, k);
      if constexpr (W > 0) {
        load_row<V>(hv, have + i * w);
        if (idw) load_row<V>(iw, idw + i * w);
      }
    }
    cp_async_wait_all();
    __syncwarp();
    if (in) {
      // Sender row of slot s.
      auto src = [&](int s) -> const uint32_t* {
        return fresh_src ? fresh_src + (i * k + s) * w
                         : fresh + (long long)clamp_peer(ids[e0 + s], n) * w;
      };
      if constexpr (W > 0) {
        constexpr int G = kBatchK1<V>;
        uint32_t keep[V], before[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          keep[v] = ~hv[v] & alive_m;
          before[v] = 0u;
          if (!idw) iw[v] = 0u;
        }
        // Walk the delivering slots G at a time: the batch's gathers are
        // all in flight before the first is used.
        for (uint32_t m = ok; m;) {
          uint32_t x[G][V];
          int sl[G];
#pragma unroll
          for (int r = 0; r < G; ++r) {
            sl[r] = __ffs(m) - 1;
            if (m) {
              load_row<V>(x[r], src(sl[r]));
              m &= m - 1;
            }
          }
#pragma unroll
          for (int r = 0; r < G; ++r) {
            if (sl[r] < 0) break;
            int f = 0, iv = 0, mm = 0;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const uint32_t newly = x[r][v] & ~before[v] & keep[v];
              before[v] |= x[r][v];
              f += __popc(newly & vd[v]);
              iv += __popc(newly & ~vd[v]);
              mm += __popc(x[r][v] & ~iw[v] & vd[v]);
            }
            c_fmd[e0 + sl[r]] = (C)f;
            c_mmd[e0 + sl[r]] = (C)mm;
            c_inv[e0 + sl[r]] = (C)iv;
          }
        }
        uint32_t o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = hv[v] | (before[v] & keep[v] & vd[v]);
        store_row<V>(have_o + i * w, o);
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = before[v] & keep[v] & vd[v];
        store_row<V>(fresh_o + i * w, o);
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = before[v] & keep[v];
        store_row<V>(new_o + i * w, o);
      } else {
        // Word by word; a slot's counts accumulate in shared memory.
        for (int c = 0; c < w; ++c) {
          const uint32_t hv = __ldg(have + i * w + c);
          const uint32_t vdc = __ldg(valid + c);
          const uint32_t iwc = idw ? __ldg(idw + i * w + c) : 0u;
          const uint32_t keep = ~hv & alive_m;
          uint32_t before = 0u;
          for (uint32_t m = ok; m; m &= m - 1) {
            const int s = __ffs(m) - 1;
            const uint32_t x = __ldg(src(s) + c);
            const uint32_t newly = x & ~before & keep;
            before |= x;
            c_fmd[e0 + s] += __popc(newly & vdc);
            c_inv[e0 + s] += __popc(newly & ~vdc);
            c_mmd[e0 + s] += __popc(x & ~iwc & vdc);
          }
          const uint32_t nw = before & keep;
          have_o[i * w + c] = hv | (nw & vdc);
          fresh_o[i * w + c] = nw & vdc;
          new_o[i * w + c] = nw;
        }
      }
    }
    __syncwarp();
    warp_drain(c_fmd, fmd + p0 * k, rows * k, lane);
    warp_drain(c_mmd, mmd + p0 * k, rows * k, lane);
    warp_drain(c_inv, inv + p0 * k, rows * k, lane);
    __syncwarp();
  }
}

// ---- K2 ---------------------------------------------------------------------

// IHAVE cap + IWANT select over slots already in the receiver's random
// priority order (gossip_packed.exchange_select).  The thread walks the
// slots whose advertiser chose it and whose IHAVEs it accepts: the
// advertiser's words rows[jidx_p[i, s]] are capped at max_ihave ids (a
// running popcount over the slot's words), ids already held are dropped,
// the first advertiser of each id keeps it (`before` is the OR of the
// wants walked so far), the asks are capped at max_iwant, served asks are
// ORed into pend and the others counted as broken promises.  The words
// table has n_rows rows: the whole [N, W] table for one device, or, for a
// rank of the sharded rollout, the gathered table of its block's
// advertisers.
template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
exchange_kernel(
    const int32_t* __restrict__ jidx_p,      // [N, K]
    const uint8_t* __restrict__ adv_ok_p,    // [N, K]
    const uint8_t* __restrict__ accept_p,    // [N, K]
    const uint8_t* __restrict__ serve_p,     // [N, K]
    const uint32_t* __restrict__ rows,       // [R, W], R = n_rows
    const uint32_t* __restrict__ have_dedup, // [N, W]
    const uint8_t* __restrict__ alive,       // [N]
    uint32_t* __restrict__ pend,             // [N, W]
    float* __restrict__ broken_p,            // [N, K]
    int n, int n_rows, int k, int w_rt, int max_ihave, int max_iwant) {
  using C = Count<W>;
  constexpr int V = W > 0 ? W : 1;
  // Generic W: each walked slot's running IHAVE and IWANT counts too.
  constexpr int kPlanes = W > 0 ? 1 : 3;
  const int w = W > 0 ? W : w_rt;
  const int lane = threadIdx.x & 31;
  extern __shared__ __align__(16) uint8_t smem[];
  zero_shared(smem, kWarps * warp_bytes<W>(k, kPlanes));
  __syncthreads();
  uint8_t* mine = smem + (threadIdx.x >> 5) * warp_bytes<W>(k, kPlanes);
  int32_t* ids = reinterpret_cast<int32_t*>(mine);
  C* c_broken = reinterpret_cast<C*>(mine + align16(32 * k * 4));
  C* c_ihave = c_broken + plane_bytes<W>(k) / sizeof(C);
  C* c_iwant = c_ihave + plane_bytes<W>(k) / sizeof(C);

  const int ntiles = (n + 31) / 32;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < ntiles;
       t += gridDim.x * kWarps) {
    const long long p0 = (long long)t * 32;
    const int rows_t = min(32, n - (int)p0);
    warp_stage_words(ids, jidx_p + p0 * k, rows_t * k, lane);
    // The lane's own rows load while the advertiser ids arrive.
    const bool in = lane < rows_t;
    const long long i = p0 + lane;
    const int e0 = lane * k;
    uint32_t walk = 0u, serve = 0u, alive_m = 0u, dd[V];
    if (in) {
      alive_m = alive[i] ? 0xffffffffu : 0u;
      walk = slot_bits(adv_ok_p + i * k, accept_p + i * k, k);
      serve = slot_bits(serve_p + i * k, serve_p + i * k, k);
      if constexpr (W > 0) load_row<V>(dd, have_dedup + i * w);
    }
    cp_async_wait_all();
    __syncwarp();
    if (in) {
      auto src = [&](int s) -> const uint32_t* {
        return rows + (long long)clamp_peer(ids[e0 + s], n_rows) * w;
      };
      if constexpr (W > 0) {
        constexpr int G = kBatchK2<V>;
        uint32_t before[V], served[V];
#pragma unroll
        for (int v = 0; v < V; ++v) before[v] = served[v] = 0u;
        // Walk the advertising slots G at a time: the batch's gathers are
        // all in flight before the first is used.
        for (uint32_t m = walk; m;) {
          uint32_t a[G][V];
          int sl[G];
#pragma unroll
          for (int r = 0; r < G; ++r) {
            sl[r] = __ffs(m) - 1;
            if (m) {
              load_row<V>(a[r], src(sl[r]));
              m &= m - 1;
            }
          }
#pragma unroll
          for (int r = 0; r < G; ++r) {
            if (sl[r] < 0) break;
            const bool sv = (serve >> sl[r]) & 1u;
            int ci = 0, cw = 0, br = 0;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              ci += __popc(a[r][v]);
              const uint32_t want = ci > max_ihave ? 0u : a[r][v] & ~dd[v];
              const uint32_t first = want & ~before[v];
              before[v] |= want;
              cw += __popc(first);
              const uint32_t asked = cw > max_iwant ? 0u : first;
              if (sv) served[v] |= asked;
              else br += __popc(asked);
            }
            c_broken[e0 + sl[r]] = (C)br;
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) served[v] &= alive_m;
        store_row<V>(pend + i * w, served);
      } else {
        for (int c = 0; c < w; ++c) {
          const uint32_t dd = __ldg(have_dedup + i * w + c);
          uint32_t before = 0u, served = 0u;
          for (uint32_t m = walk; m; m &= m - 1) {
            const int s = __ffs(m) - 1;
            const uint32_t a = __ldg(src(s) + c);
            const C ci = (c ? c_ihave[e0 + s] : 0u) + __popc(a);
            c_ihave[e0 + s] = ci;
            const uint32_t want = (long long)ci > max_ihave ? 0u : a & ~dd;
            const uint32_t first = want & ~before;
            before |= want;
            const C cw = (c ? c_iwant[e0 + s] : 0u) + __popc(first);
            c_iwant[e0 + s] = cw;
            const uint32_t asked = (long long)cw > max_iwant ? 0u : first;
            if ((serve >> s) & 1u) served |= asked;
            else c_broken[e0 + s] += __popc(asked);
          }
          pend[i * w + c] = served & alive_m;
        }
      }
    }
    __syncwarp();
    warp_drain(c_broken, broken_p + p0 * k, rows_t * k, lane);
    __syncwarp();
  }
}

// ---- launch -----------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_setup(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int W>
int launch_propagate(const void* mesh, const void* edge_live, const void* nbrs,
                     const void* alive, const void* have, const void* fresh,
                     const void* fresh_src, const void* idw, const void* valid,
                     void* have_o, void* fresh_o, void* new_o, void* fmd,
                     void* mmd, void* inv, int n, int k, int w, int grid,
                     cudaStream_t stream) {
  const int smem = propagate_smem<W>(k);
  cudaError_t err = launch_setup(propagate_kernel<W>, smem);
  if (err != cudaSuccess) return (int)err;
  propagate_kernel<W><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)mesh, (const uint8_t*)edge_live, (const int32_t*)nbrs,
      (const uint8_t*)alive, (const uint32_t*)have, (const uint32_t*)fresh,
      (const uint32_t*)fresh_src, (const uint32_t*)idw, (const uint32_t*)valid,
      (uint32_t*)have_o, (uint32_t*)fresh_o, (uint32_t*)new_o, (float*)fmd,
      (float*)mmd, (float*)inv, n, k, w);
  return (int)cudaGetLastError();
}

template <int W>
int launch_exchange(const void* jidx_p, const void* adv_ok_p,
                    const void* accept_p, const void* serve_p, const void* rows,
                    const void* have_dedup, const void* alive, void* pend,
                    void* broken_p, int n, int n_rows, int k, int w,
                    int max_ihave, int max_iwant, int grid,
                    cudaStream_t stream) {
  const int smem = exchange_smem<W>(k);
  cudaError_t err = launch_setup(exchange_kernel<W>, smem);
  if (err != cudaSuccess) return (int)err;
  exchange_kernel<W><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)jidx_p, (const uint8_t*)adv_ok_p,
      (const uint8_t*)accept_p, (const uint8_t*)serve_p, (const uint32_t*)rows,
      (const uint32_t*)have_dedup, (const uint8_t*)alive, (uint32_t*)pend,
      (float*)broken_p, n, n_rows, k, w, max_ihave, max_iwant);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` at `smem` bytes of shared memory an SM of the current
// device holds at once, from its registers and shared memory.
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, int* out) {
  cudaError_t err = launch_setup(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                        smem);
  return (int)err;
}

template <int W>
int launch_shape(int kernel, int k, int* out) {
  out[0] = kThreads;
  return kernel == 0
             ? resident_blocks(propagate_kernel<W>, propagate_smem<W>(k),
                               out + 1)
             : resident_blocks(exchange_kernel<W>, exchange_smem<W>(k),
                               out + 1);
}

}  // namespace

// The launch shape of one instantiation on the current device, for the
// caller's grid plan: out[0] peers a block takes per tile (one a thread),
// out[1] blocks an SM holds at once at this K.  `kernel` is 0 for K1 and
// 1 for K2; `variant` as below.
extern "C" int gossip_launch_shape(int kernel, int variant, int k, int* out) {
  if (kernel < 0 || kernel > 1 || k < 0 || k > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 1: return launch_shape<1>(kernel, k, out);
    case 2: return launch_shape<2>(kernel, k, out);
    case 4: return launch_shape<4>(kernel, k, out);
    case 8: return launch_shape<8>(kernel, k, out);
    case 0: return launch_shape<0>(kernel, k, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// `variant` is W's instantiation (1, 2, 4, 8) or 0 for the generic one;
// `grid` the number of persistent blocks (at most one per tile).
extern "C" int gossip_propagate(
    const void* mesh, const void* edge_live, const void* nbrs,
    const void* alive, const void* have, const void* fresh,
    const void* fresh_src, const void* idw, const void* valid,
    void* have_o, void* fresh_o, void* new_o,
    void* fmd, void* mmd, void* inv,
    int n, int k, int w, int variant, int grid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k < 0 || k > kMaxSlots || grid < 1) return (int)cudaErrorInvalidValue;
  if (variant != 0 && variant != w) return (int)cudaErrorInvalidValue;
#define GOSSIP_PROPAGATE(WV)                                                 \
  launch_propagate<WV>(mesh, edge_live, nbrs, alive, have, fresh, fresh_src, \
                       idw, valid, have_o, fresh_o, new_o, fmd, mmd, inv, n, \
                       k, w, grid, (cudaStream_t)stream)
  switch (variant) {
    case 1: return GOSSIP_PROPAGATE(1);
    case 2: return GOSSIP_PROPAGATE(2);
    case 4: return GOSSIP_PROPAGATE(4);
    case 8: return GOSSIP_PROPAGATE(8);
    case 0: return GOSSIP_PROPAGATE(0);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GOSSIP_PROPAGATE
}

extern "C" int gossip_exchange(
    const void* jidx_p, const void* adv_ok_p, const void* accept_p,
    const void* serve_p, const void* rows, const void* have_dedup,
    const void* alive, void* pend, void* broken_p,
    int n, int n_rows, int k, int w, int max_ihave, int max_iwant, int variant,
    int grid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k < 0 || k > kMaxSlots || grid < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (variant != 0 && variant != w) return (int)cudaErrorInvalidValue;
#define GOSSIP_EXCHANGE(WV)                                                  \
  launch_exchange<WV>(jidx_p, adv_ok_p, accept_p, serve_p, rows, have_dedup, \
                      alive, pend, broken_p, n, n_rows, k, w, max_ihave,     \
                      max_iwant, grid, (cudaStream_t)stream)
  switch (variant) {
    case 1: return GOSSIP_EXCHANGE(1);
    case 2: return GOSSIP_EXCHANGE(2);
    case 4: return GOSSIP_EXCHANGE(4);
    case 8: return GOSSIP_EXCHANGE(8);
    case 0: return GOSSIP_EXCHANGE(0);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GOSSIP_EXCHANGE
}
