// The flight recorder's latency histogram as one kernel (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves the recount to XLA's
// scatter-add.  The port wrote it as PyTorch (ops/histogram.py): a clamp
// and a mask over the whole stamp table, then index_add_ of ones onto
// n_bins + 1 bins, the last an overflow bin for the uncounted stamps.
// Every stamp became a global atomic on one of 33 addresses, most of them
// on the same few (the overflow bin and the low latencies): 68 ms for the
// two-topic stream's [2, 100000, 512] table on the H100, about 0.2% of
// its bytes bound, while the serving chunk's digest read waited for it.
//
// Bound on the card: device-memory bytes.  Each stamp is read once (4
// bytes; [2, 100000, 512] is 409.6 MB, 0.122 ms at 3.35 TB/s); the masks
// and births are small and the output is n_bins words.
//
// Design.  blockIdx.y is the topic: its message births and message mask
// are staged once in shared memory.  A warp takes groups of 32 peer rows,
// reads their peer mask as one ballot and never reads a masked row; it
// walks the live rows kRows at a time, each lane reading 16-byte vectors
// of stamps, so kRows vectors a lane are in flight.  When the table's rows
// do not start on 16 bytes (M not a multiple of 4) a row has a scalar head
// and tail around its vectors.  Counts go into private bins, one column a
// thread, in shared memory laid out [bin][thread]: a warp's increments
// fall on its 32 lanes' banks whatever the latencies, so stamps of equal
// latency never queue on one address and no atomic is taken until the
// block's end.  There each warp sums its share of the bins over the
// block's columns (a shuffle tree) and adds each nonzero bin to the output
// with one global atomicAdd.  An uncounted stamp costs its load alone.
// The caller sizes the grid to the blocks the SMs hold at once
// (latency_hist_occupancy), so every block is resident and loops over its
// topic's groups.
//
// What it counts: out[bin] += #{(t, n, m) : first[t, n, m] >= 0,
// peer_on[t, n], msg_on[t, m], clamp(first - birth[t, m], 0, n_bins - 1)
// == bin}, the difference wrapping at 32 bits as PyTorch's int32
// subtraction does.  Integers added in any order are the same integers,
// so the result is exact.
//
// The per-lane work is plain C++ behind one macro.  Without nvcc the
// source builds a host entry point (latency_hist_host) that runs it for
// each warp's lanes in turn, which the CPU tests hold to PyTorch.
//
// Plain C interface for ctypes: latency_hist_launch launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <stdint.h>
#include <string.h>

#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LH_FN __host__ __device__ __forceinline__
#else
#define LH_FN inline
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;             // live rows a warp reads at once
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kMaxTopics = 65535;    // gridDim.y
constexpr int kInvalid = 1;          // cudaErrorInvalidValue

struct Args {
  const int32_t* first;    // int32[T, N, M]: first-receipt round, -1 never
  const int32_t* birth;    // int32[T, M]
  const uint8_t* msg_on;   // bool[T, M]
  const uint8_t* peer_on;  // bool[T, N]
  int32_t* out;            // int32[n_bins], zeroed by the caller
  int t, n, m, n_bins;
  int vec;                 // `first` starts on 16 bytes
};

struct Stamps4 {
  int32_t v[4];
};

LH_FN Stamps4 load4(const int32_t* p) {
#ifdef __CUDA_ARCH__
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  return Stamps4{{q.x, q.y, q.z, q.w}};
#else
  Stamps4 s;
  memcpy(s.v, p, sizeof(s.v));
  return s;
#endif
}

LH_FN int32_t load1(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcs(p);
#else
  return *p;
#endif
}

LH_FN int first_set(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ffs(x) - 1;
#endif
}

// One stamp into a thread's column of bins (`stride` words apart).
LH_FN void count(uint32_t* col, int stride, int32_t stamp, int32_t birth,
                 uint8_t on, int n_bins) {
  if (stamp < 0 || !on) return;
  const int32_t lat =
      static_cast<int32_t>(static_cast<uint32_t>(stamp) -
                           static_cast<uint32_t>(birth));
  const int bin = lat < 0 ? 0 : (lat >= n_bins ? n_bins - 1 : lat);
  col[bin * stride] += 1u;
}

// Takes up to kRows live rows of a group (rows row0 + bit of `live`) off
// `live`; base[u] is row u's first element.  Returns how many it took.
LH_FN int take_rows(unsigned& live, long long row0, int m, long long* base) {
  int k = 0;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    base[u] = 0;
    if (live) {
      base[u] = (row0 + first_set(live)) * m;
      live &= live - 1u;
      k = u + 1;
    }
  }
  return k;
}

// A lane's share of k rows: the vectors j = lane, lane + 32, ... of every
// row (one load a row in flight at each j), then the scalar head and tail.
// `birth` and `on` are the topic's [M] births and message mask.
LH_FN void lane_rows(const Args& a, const long long* base, int k, int lane,
                     const int32_t* birth, const uint8_t* on, uint32_t* col,
                     int stride) {
  const int m = a.m;
  int head[kRows], nvec[kRows];
  int most = 0;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    int h = m;
    if (a.vec) {
      h = static_cast<int>((4 - (base[u] & 3)) & 3);
      if (h > m) h = m;
    }
    head[u] = h;
    nvec[u] = u < k ? (m - h) >> 2 : 0;
    if (nvec[u] > most) most = nvec[u];
  }
  for (int j = lane; j < most; j += 32) {
    Stamps4 v[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      if (j < nvec[u]) v[u] = load4(a.first + base[u] + head[u] + 4 * j);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (j >= nvec[u]) continue;
      const int m0 = head[u] + 4 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        count(col, stride, v[u].v[i], birth[m0 + i], on[m0 + i], a.n_bins);
    }
  }
  for (int u = 0; u < k; ++u) {
    const int body = head[u] + 4 * nvec[u];
    const int rest = head[u] + (m - body);
    for (int i = lane; i < rest; i += 32) {
      const int mi = i < head[u] ? i : body + (i - head[u]);
      count(col, stride, load1(a.first + base[u] + mi), birth[mi], on[mi],
            a.n_bins);
    }
  }
}

int smem_bytes(int n_bins, int m) {
  const long long bytes = 4LL * n_bins * kThreads + 4LL * m + ((m + 3) & ~3);
  return bytes > kMaxSmem ? -1 : static_cast<int>(bytes);
}

int check(const Args& a) {
  if (a.t < 0 || a.t > kMaxTopics || a.n < 0 || a.n > (1 << 30) ||
      a.m < 0 || a.n_bins < 1 || smem_bytes(a.n_bins, a.m) < 0)
    return kInvalid;
  return 0;
}

Args make_args(const void* first, const void* birth, const void* msg_on,
               const void* peer_on, void* out, int t, int n, int m,
               int n_bins) {
  return Args{static_cast<const int32_t*>(first),
              static_cast<const int32_t*>(birth),
              static_cast<const uint8_t*>(msg_on),
              static_cast<const uint8_t*>(peer_on),
              static_cast<int32_t*>(out),
              t, n, m, n_bins,
              (reinterpret_cast<uintptr_t>(first) & 15) == 0};
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads) latency_hist_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  uint32_t* bins = smem;                                        // [bin][thread]
  int32_t* birth = reinterpret_cast<int32_t*>(bins + a.n_bins * kThreads);
  uint8_t* on = reinterpret_cast<uint8_t*>(birth + a.m);
  const int topic = blockIdx.y;
  for (int i = threadIdx.x; i < a.n_bins * kThreads; i += kThreads)
    bins[i] = 0u;
  const long long msg0 = static_cast<long long>(topic) * a.m;
  for (int i = threadIdx.x; i < a.m; i += kThreads) {
    birth[i] = a.birth[msg0 + i];
    on[i] = a.msg_on[msg0 + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* col = bins + threadIdx.x;
  const long long peer0 = static_cast<long long>(topic) * a.n;
  const int step = gridDim.x * kWarps * 32;
  for (int n0 = (blockIdx.x * kWarps + warp) * 32; n0 < a.n; n0 += step) {
    const int n = n0 + lane;
    unsigned live =
        __ballot_sync(0xffffffffu, n < a.n && a.peer_on[peer0 + n] != 0);
    while (live) {
      long long base[kRows];
      const int k = take_rows(live, peer0 + n0, a.m, base);
      lane_rows(a, base, k, lane, birth, on, col, kThreads);
    }
  }
  __syncthreads();

  for (int b = warp; b < a.n_bins; b += kWarps) {
    uint32_t s = 0u;
    for (int i = lane; i < kThreads; i += 32) s += bins[b * kThreads + i];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && s) atomicAdd(reinterpret_cast<unsigned*>(a.out) + b, s);
  }
}

cudaError_t launch_setup(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(latency_hist_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

#endif  // __CUDACC__

}  // namespace

// The host build of the same per-lane work (the CPU tests' entry point):
// every topic's groups of 32 rows in turn, a group's lanes in turn, each
// lane into its own column of bins; the columns summed into `out`.
extern "C" int latency_hist_host(const void* first, const void* birth,
                                 const void* msg_on, const void* peer_on,
                                 void* out, int t, int n, int m, int n_bins) {
  const Args a = make_args(first, birth, msg_on, peer_on, out, t, n, m,
                           n_bins);
  if (const int bad = check(a)) return bad;
  std::vector<uint32_t> bins(static_cast<size_t>(n_bins) * 32, 0u);
  for (int topic = 0; topic < t; ++topic) {
    const long long peer0 = static_cast<long long>(topic) * n;
    const int32_t* tb = a.birth + static_cast<long long>(topic) * m;
    const uint8_t* to = a.msg_on + static_cast<long long>(topic) * m;
    for (int n0 = 0; n0 < n; n0 += 32) {
      unsigned live = 0u;
      for (int lane = 0; lane < 32; ++lane)
        if (n0 + lane < n && a.peer_on[peer0 + n0 + lane])
          live |= 1u << lane;
      while (live) {
        long long base[kRows];
        const int k = take_rows(live, peer0 + n0, m, base);
        for (int lane = 0; lane < 32; ++lane)
          lane_rows(a, base, k, lane, tb, to, bins.data() + lane, 32);
      }
    }
  }
  for (int b = 0; b < n_bins; ++b) {
    uint32_t s = 0u;
    for (int lane = 0; lane < 32; ++lane) s += bins[b * 32 + lane];
    a.out[b] = static_cast<int32_t>(static_cast<uint32_t>(a.out[b]) + s);
  }
  return 0;
}

#ifdef __CUDACC__

// Blocks an SM of the current device holds at once at (n_bins, m), from
// the kernel's registers and its shared memory, for the caller's grid.
extern "C" int latency_hist_occupancy(int n_bins, int m, int* blocks_per_sm) {
  const int smem = n_bins < 1 || m < 0 ? -1 : smem_bytes(n_bins, m);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_setup(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, latency_hist_kernel, kThreads, smem);
  return (int)err;
}

// A grid of `grid` x t blocks of kThreads threads (the caller sizes `grid`
// to the blocks the SMs hold at once, split over the topics).
extern "C" int latency_hist_launch(const void* first, const void* birth,
                                   const void* msg_on, const void* peer_on,
                                   void* out, int t, int n, int m, int n_bins,
                                   int grid, void* stream) {
  const Args a = make_args(first, birth, msg_on, peer_on, out, t, n, m,
                           n_bins);
  if (check(a) || grid < 1) return (int)cudaErrorInvalidValue;
  if (static_cast<long long>(t) * n * m == 0) return (int)cudaGetLastError();
  const int smem = smem_bytes(n_bins, m);
  cudaError_t err = launch_setup(smem);
  if (err != cudaSuccess) return (int)err;
  latency_hist_kernel<<<dim3(grid, t), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
