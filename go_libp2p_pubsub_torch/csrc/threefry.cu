// The port's PRNG as one kernel: the threefry-2x32 hash of jax.random's
// partitionable draws (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves jax.random to XLA,
// which fuses the hash into one loop.  The port wrote the hash as plain
// elementwise PyTorch (ops/rng.py), which made every key split and every
// uniform draw about 160 launches: 5 x (4 rotations x 6 ops + 3 key
// injections) for the rounds, and some 25 more for the key schedule, the
// counters and the output.  On the H100 that was 1.85-1.89 ms of host time
// for a 2-key split (45% of a closed-loop episode at 100k peers, where
// every publish splits the key once) and 1.28 ms of device time for a
// [100000, 32] uniform draw, whose ~160 passes each read and write 13-38
// MB.  Here one launch computes a whole draw.
//
// Bound on the card: integer operations.  An element takes its 64-bit
// counter (three forms, below), runs the 20 rounds and 5 key injections
// (~75 int32 operations: an add, a funnel-shift rotation and a xor a
// round) and stores 4 or 8 bytes.  A [100000, 32] draw is ~3.2M x 75
// int32 operations, ~15 us at the card's int32 rate, against ~4 us for its
// 12.8 MB of stores.  A split of a few keys is bound by its launch alone.
//
// One thread an element over a grid-stride loop, so a warp's 4- or 8-byte
// stores are 128 or 256 contiguous bytes.  The key (int32[2]) is read from
// device memory by every thread: no key ever reaches the host.
//
// Counter forms (the element's flat index i):
//   kRange  start + i                      split, uniform, bits, row_offset
//   kRows   rows[i / inner] * inner + i % inner    uniform_rows, rows=
//   kData   (0, data[i] mod 2**32)         fold_in
// Outputs:
//   kPair     int32[n, 2]: both words     split, fold_in
//   kBits     int32[n]: their xor         jax.random.bits (32 bits)
//   kUniform  float32[n]: (bits >> 9) | 0x3F800000 as a float, minus 1,
//             times width (or fused with + lo when minval != 0, as
//             ops/fma.py rounds it), clamped at lo
//   kRandint  int32[n]: jax.random.randint over the key's two subkeys
//             (split(key, 2), derived by each thread once): the lower
//             draw's bits, and the higher draw's where the span needs
//             them (ops/rng.py:randint)
//
// The arithmetic is plain C++ behind one macro.  Without nvcc the source
// builds a host entry point (threefry_host) that runs the same element
// function in a loop, which the CPU tests hold to the PyTorch chain.
//
// Plain C interface for ctypes: threefry_launch launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <stdint.h>
#include <string.h>

#include <cmath>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TF_FN __host__ __device__ __forceinline__
#else
#define TF_FN inline
#endif

namespace {

enum Form { kRange = 0, kRows = 1, kData = 2 };
enum Out { kPair = 0, kBits = 1, kUniform = 2, kRandint = 3 };

constexpr int kThreads = 256;
constexpr int kInvalid = 1;  // cudaErrorInvalidValue

struct Args {
  const int32_t* key;
  const void* idx;  // kRows: int[n / inner] row ids; kData: int[n] data
  int idx_bytes;    // 4 or 8
  int form;
  long long start, n, inner;
  void* out;
  float lo, width;
  int use_fma;
  uint32_t span, mult, minval;
};

struct Key3 {
  uint32_t k0, k1, k2;
};

TF_FN Key3 schedule(uint32_t a, uint32_t b) {
  return Key3{a, b, a ^ b ^ 0x1BD11BDAu};
}

TF_FN uint32_t rotl(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// Threefry-2x32, 20 rounds: the counter (hi, lo) under key ks.
TF_FN void hash(const Key3& ks, uint32_t hi, uint32_t lo, uint32_t& o0,
                uint32_t& o1) {
  uint32_t x0 = hi + ks.k0, x1 = lo + ks.k1;
#define TF_MIX(R) \
  x0 += x1;       \
  x1 = rotl(x1, R) ^ x0;
#define TF_ROUNDS_A TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
#define TF_ROUNDS_B TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  TF_ROUNDS_A x0 += ks.k1; x1 += ks.k2 + 1u;
  TF_ROUNDS_B x0 += ks.k2; x1 += ks.k0 + 2u;
  TF_ROUNDS_A x0 += ks.k0; x1 += ks.k1 + 3u;
  TF_ROUNDS_B x0 += ks.k1; x1 += ks.k2 + 4u;
  TF_ROUNDS_A x0 += ks.k2; x1 += ks.k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_MIX
  o0 = x0;
  o1 = x1;
}

TF_FN long long load_idx(const Args& a, long long i) {
  return a.idx_bytes == 8 ? static_cast<const int64_t*>(a.idx)[i]
                          : static_cast<const int32_t*>(a.idx)[i];
}

TF_FN uint64_t counter(const Args& a, long long i) {
  if (a.form == kRange) return static_cast<uint64_t>(a.start + i);
  if (a.form == kRows) {
    const long long r = i / a.inner;
    return static_cast<uint64_t>(load_idx(a, r) * a.inner + (i - r * a.inner));
  }
  return static_cast<uint32_t>(load_idx(a, i));
}

TF_FN float as_float(uint32_t bits) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

// The draw's keys: the key itself, and for kRandint the two subkeys of
// split(key, 2) (counters (0, 0) and (0, 1)): the lower draw's in `main`,
// the higher's in `higher`.
TF_FN void keys(const Args& a, int out, Key3& main, Key3& higher) {
  main = schedule(static_cast<uint32_t>(a.key[0]),
                  static_cast<uint32_t>(a.key[1]));
  higher = main;
  if (out == kRandint) {
    uint32_t h0, h1, l0, l1;
    hash(main, 0u, 0u, h0, h1);
    hash(main, 0u, 1u, l0, l1);
    main = schedule(l0, l1);
    higher = schedule(h0, h1);
  }
}

template <int OUT>
TF_FN void element(const Args& a, const Key3& ks, const Key3& kh,
                   long long i) {
  const uint64_t c = counter(a, i);
  const uint32_t chi = static_cast<uint32_t>(c >> 32);
  const uint32_t clo = static_cast<uint32_t>(c);
  uint32_t x0, x1;
  hash(ks, chi, clo, x0, x1);
  if (OUT == kPair) {
    uint32_t* o = static_cast<uint32_t*>(a.out) + 2 * i;
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint2*>(o) = make_uint2(x0, x1);
#else
    o[0] = x0;
    o[1] = x1;
#endif
  } else if (OUT == kBits) {
    static_cast<uint32_t*>(a.out)[i] = x0 ^ x1;
  } else if (OUT == kUniform) {
    const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
    float v;
#ifdef __CUDA_ARCH__
    const float f = __fsub_rn(as_float(bits), 1.0f);
    v = a.use_fma ? __fmaf_rn(f, a.width, a.lo) : __fmul_rn(f, a.width);
#else
    const float f = as_float(bits) - 1.0f;
    v = a.use_fma ? std::fmaf(f, a.width, a.lo) : f * a.width;
#endif
    static_cast<float*>(a.out)[i] = v < a.lo ? a.lo : v;
  } else {
    const uint32_t lower = x0 ^ x1;
    uint32_t offset;
    if ((a.span & (a.span - 1u)) == 0u) {
      offset = lower & (a.span - 1u);
    } else {
      offset = lower % a.span;
      if (a.mult) {
        uint32_t y0, y1;
        hash(kh, chi, clo, y0, y1);
        offset = ((y0 ^ y1) % a.span * a.mult + offset) % a.span;
      }
    }
    static_cast<uint32_t*>(a.out)[i] = offset + a.minval;
  }
}

int check(const Args& a, int out) {
  if (out < kPair || out > kRandint || a.form < kRange || a.form > kData)
    return kInvalid;
  if (a.form != kRange && a.idx_bytes != 4 && a.idx_bytes != 8)
    return kInvalid;
  if (a.form == kRows && a.inner < 1) return kInvalid;
  if (out == kRandint && a.span == 0u) return kInvalid;
  return 0;
}

Args make_args(const void* key, const void* idx, int idx_bytes, int form,
               long long start, long long n, long long inner, void* out,
               float lo, float width, int use_fma, unsigned span,
               unsigned mult, unsigned minval) {
  return Args{static_cast<const int32_t*>(key), idx, idx_bytes, form, start,
              n, inner, out, lo, width, use_fma, span, mult, minval};
}

#ifdef __CUDACC__

template <int OUT>
__global__ void __launch_bounds__(kThreads) threefry_kernel(Args a) {
  Key3 ks, kh;
  keys(a, OUT, ks, kh);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < a.n; i += stride)
    element<OUT>(a, ks, kh, i);
}

#endif  // __CUDACC__

template <int OUT>
void host_loop(const Args& a) {
  Key3 ks, kh;
  keys(a, OUT, ks, kh);
  for (long long i = 0; i < a.n; ++i) element<OUT>(a, ks, kh, i);
}

}  // namespace

// The host build of the same arithmetic (the CPU tests' entry point).
extern "C" int threefry_host(const void* key, const void* idx, int idx_bytes,
                             int form, int out, long long start, long long n,
                             long long inner, void* dst, float lo,
                             float width, int use_fma, unsigned span,
                             unsigned mult, unsigned minval) {
  const Args a = make_args(key, idx, idx_bytes, form, start, n, inner, dst,
                           lo, width, use_fma, span, mult, minval);
  if (const int bad = check(a, out)) return bad;
  switch (out) {
    case kPair: host_loop<kPair>(a); break;
    case kBits: host_loop<kBits>(a); break;
    case kUniform: host_loop<kUniform>(a); break;
    default: host_loop<kRandint>(a); break;
  }
  return 0;
}

#ifdef __CUDACC__

// `grid` blocks of kThreads threads walk the n elements (the caller sizes
// it: one thread an element, at most a few blocks a multiprocessor).
extern "C" int threefry_launch(const void* key, const void* idx,
                               int idx_bytes, int form, int out,
                               long long start, long long n, long long inner,
                               void* dst, float lo, float width, int use_fma,
                               unsigned span, unsigned mult, unsigned minval,
                               int grid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const Args a = make_args(key, idx, idx_bytes, form, start, n, inner, dst,
                           lo, width, use_fma, span, mult, minval);
  if (check(a, out) || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out) {
    case kPair: threefry_kernel<kPair><<<grid, kThreads, 0, s>>>(a); break;
    case kBits: threefry_kernel<kBits><<<grid, kThreads, 0, s>>>(a); break;
    case kUniform:
      threefry_kernel<kUniform><<<grid, kThreads, 0, s>>>(a);
      break;
    default: threefry_kernel<kRandint><<<grid, kThreads, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
