// Kernel E1: batched ed25519 verification on Hopper (sm_90a), one thread
// per signature.
//
// Replaces go_libp2p_pubsub_tpu/ops/ed25519.py:_verify_kernel_windowed_bm
// (and _verify_kernel_bm, its Straus ladder): batch-major limb arithmetic
// that XLA compiles into one program on the TPU (no Pallas kernel).  Same
// verdict: non-cofactored [S]B == R + [k]A, with k = SHA512(R||A||M) mod L
// from the host, A and R decompressed (x = u v^3 (u v^7)^((p-5)/8), times sqrt(-1)
// when v x^2 == -u, rejecting a y with no root and the -0 encoding), the
// projective compare, and a_ok & r_ok & eq.  The host checks S < L and
// y < p and ANDs them in afterwards (ops/ed25519.py:prepare_rows).
//
// Bound: integer multiplies, not bytes.  A signature brings 128 bytes (A,
// R, S, k) and takes 1 byte out, against ~3.7k field multiplies of 25
// 64x64->128-bit limb products each at w = 4.  What the design does about it:
// - field elements are radix 2^51 in five u64 limbs (the representation of
//   the host library, native/ed25519/ed25519.cpp, whose arithmetic this
//   rewrites for the device): 25 limb products a multiply, where the
//   twin's 22 limbs of 12 bits need 484;
// - the decompression square root takes the fixed addition chain for
//   2^252 - 3 (251 squarings + 11 multiplies, not 253 + ~250);
// - the ladder retires w bits of both scalars a step: w dedicated
//   doublings (dbl-2008-hwcd, 8 multiplies), one add of [i]B from a table
//   the host makes from the oracle (global memory, niels form, 7
//   multiplies) and one add of [j](-A) from the thread's own chain of 2^w
//   points (local memory, cached form, 8 multiplies).  Two adds a step
//   instead of the twin's 4^w joint grid; verdict-identical, because the
//   group arithmetic is exact;
// - no data-dependent branch: the sqrt(-1) fix and the sign flip are
//   selects, every step adds (identity entries absorb zero windows), so a
//   warp never diverges and the multiply count does not depend on the data;
// - the point operations are out-of-line calls, so the ladder's loop fits
//   the instruction cache (see ge_add).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/cuda_ed25519.py:build).  The C entry points launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define E1_DEV __device__ __forceinline__
#define E1_FN __device__
#define E1_CALL __device__ __noinline__
#define E1_LDG(p) __ldg(p)
#else  // the arithmetic is plain C++ and also compiles for the host
#define E1_DEV inline
#define E1_FN inline
#define E1_CALL inline
#define E1_LDG(p) (*(p))
#endif

namespace e1 {

typedef unsigned long long u64;
typedef unsigned __int128 u128;

constexpr u64 MASK51 = (1ULL << 51) - 1;

struct fe {
  u64 v[5];
};
struct ge {  // extended coordinates: x = X/Z, y = Y/Z, XY = ZT
  fe x, y, z, t;
};
struct ge_cached {  // (Y+X, Y-X, Z, 2dT): an add operand
  fe ypx, ymx, z, t2d;
};
struct ge_niels {  // affine (Z = 1): (y+x, y-x, 2dxy)
  fe ypx, ymx, t2d;
};

E1_DEV fe fe_const(u64 a, u64 b, u64 c, u64 d, u64 e) {
  fe o;
  o.v[0] = a; o.v[1] = b; o.v[2] = c; o.v[3] = d; o.v[4] = e;
  return o;
}
E1_DEV fe fe_zero() { return fe_const(0, 0, 0, 0, 0); }
E1_DEV fe fe_one() { return fe_const(1, 0, 0, 0, 0); }
E1_DEV fe fe_d() {  // -121665/121666
  return fe_const(929955233495203ULL, 466365720129213ULL, 1662059464998953ULL,
                  2033849074728123ULL, 1442794654840575ULL);
}
E1_DEV fe fe_2d() {
  return fe_const(1859910466990425ULL, 932731440258426ULL, 1072319116312658ULL,
                  1815898335770999ULL, 633789495995903ULL);
}
E1_DEV fe fe_sqrt_m1() {  // 2^((p-1)/4)
  return fe_const(1718705420411056ULL, 234908883556509ULL, 2233514472574048ULL,
                  2117202627021982ULL, 765476049583133ULL);
}

// Weak reduction: limbs below 2^54 in, below 2^51 (+ a small carry in
// limb 1) out.
E1_DEV void fe_carry(fe& o) {
  u64 c;
  c = o.v[0] >> 51; o.v[0] &= MASK51; o.v[1] += c;
  c = o.v[1] >> 51; o.v[1] &= MASK51; o.v[2] += c;
  c = o.v[2] >> 51; o.v[2] &= MASK51; o.v[3] += c;
  c = o.v[3] >> 51; o.v[3] &= MASK51; o.v[4] += c;
  c = o.v[4] >> 51; o.v[4] &= MASK51; o.v[0] += 19 * c;
  c = o.v[0] >> 51; o.v[0] &= MASK51; o.v[1] += c;
}

E1_DEV fe fe_add(const fe& a, const fe& b) {
  fe o;
  for (int i = 0; i < 5; ++i) o.v[i] = a.v[i] + b.v[i];
  fe_carry(o);
  return o;
}

// a - b + 4p, so every limb stays nonnegative.
E1_DEV fe fe_sub(const fe& a, const fe& b) {
  fe o;
  o.v[0] = a.v[0] + 0x1FFFFFFFFFFFB4ULL - b.v[0];  // 4 (2^51 - 19)
  for (int i = 1; i < 5; ++i) o.v[i] = a.v[i] + 0x1FFFFFFFFFFFFCULL - b.v[i];
  fe_carry(o);
  return o;
}

// The field multiply: 25 limb products, 2^255 = 19 folded into the low
// ones.  Inputs are weakly reduced (limbs < 2^52), so every column sum
// stays below 2^115 and every carry fits a u64.
E1_DEV fe fe_mul(const fe& a, const fe& b) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  const u64 a1_19 = 19 * a1, a2_19 = 19 * a2, a3_19 = 19 * a3, a4_19 = 19 * a4;
  u128 t0 = (u128)a0 * b0 + (u128)a1_19 * b4 + (u128)a2_19 * b3 +
            (u128)a3_19 * b2 + (u128)a4_19 * b1;
  u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2_19 * b4 +
            (u128)a3_19 * b3 + (u128)a4_19 * b2;
  u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
            (u128)a3_19 * b4 + (u128)a4_19 * b3;
  u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 + (u128)a3 * b0 +
            (u128)a4_19 * b4;
  u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 + (u128)a3 * b1 +
            (u128)a4 * b0;
  fe o;
  t1 += (u64)(t0 >> 51); o.v[0] = (u64)t0 & MASK51;
  t2 += (u64)(t1 >> 51); o.v[1] = (u64)t1 & MASK51;
  t3 += (u64)(t2 >> 51); o.v[2] = (u64)t2 & MASK51;
  t4 += (u64)(t3 >> 51); o.v[3] = (u64)t3 & MASK51;
  const u64 c = (u64)(t4 >> 51); o.v[4] = (u64)t4 & MASK51;
  o.v[0] += 19 * c;
  o.v[1] += o.v[0] >> 51;
  o.v[0] &= MASK51;
  return o;
}

E1_DEV fe fe_sq(const fe& a) { return fe_mul(a, a); }

E1_DEV fe fe_sqn(fe a, int n) {
  for (int i = 0; i < n; ++i) a = fe_sq(a);
  return a;
}

// The canonical value in [0, p).
E1_DEV fe fe_freeze(fe t) {
  fe_carry(t);
  fe_carry(t);
  u64 q = (t.v[0] + 19) >> 51;  // q = 1 iff t >= p
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  t.v[4] &= MASK51;
  return t;
}

E1_DEV bool fe_is_zero(const fe& a) {
  const fe f = fe_freeze(a);
  return (f.v[0] | f.v[1] | f.v[2] | f.v[3] | f.v[4]) == 0;
}

E1_DEV u64 fe_parity(const fe& a) { return fe_freeze(a).v[0] & 1; }

E1_DEV fe fe_select(bool pick_b, const fe& a, const fe& b) {
  fe o;
  for (int i = 0; i < 5; ++i) o.v[i] = pick_b ? b.v[i] : a.v[i];
  return o;
}

// z^(2^252 - 3) = z^((p-5)/8).
E1_FN fe fe_pow22523(const fe& z) {
  fe t0 = fe_sq(z);                 // 2
  fe t1 = fe_sqn(t0, 2);            // 8
  t1 = fe_mul(z, t1);               // 9
  t0 = fe_mul(t0, t1);              // 11
  t0 = fe_sq(t0);                   // 22
  t0 = fe_mul(t1, t0);              // 2^5 - 1
  t1 = fe_sqn(t0, 5);
  t0 = fe_mul(t1, t0);              // 2^10 - 1
  t1 = fe_sqn(t0, 10);
  t1 = fe_mul(t1, t0);              // 2^20 - 1
  fe t2 = fe_sqn(t1, 20);
  t1 = fe_mul(t2, t1);              // 2^40 - 1
  t1 = fe_sqn(t1, 10);
  t0 = fe_mul(t1, t0);              // 2^50 - 1
  t1 = fe_sqn(t0, 50);
  t1 = fe_mul(t1, t0);              // 2^100 - 1
  t2 = fe_sqn(t1, 100);
  t1 = fe_mul(t2, t1);              // 2^200 - 1
  t1 = fe_sqn(t1, 50);
  t0 = fe_mul(t1, t0);              // 2^250 - 1
  t0 = fe_sqn(t0, 2);               // 2^252 - 4
  return fe_mul(t0, z);             // 2^252 - 3
}

// y from a 32-byte little-endian encoding (bit 255, the sign, dropped).
E1_DEV fe fe_from_words(u64 w0, u64 w1, u64 w2, u64 w3) {
  return fe_const(w0 & MASK51, ((w0 >> 51) | (w1 << 13)) & MASK51,
                  ((w1 >> 38) | (w2 << 26)) & MASK51,
                  ((w2 >> 25) | (w3 << 39)) & MASK51, (w3 >> 12) & MASK51);
}

// Decompression; returns whether the encoding is a valid point.
E1_FN bool ge_decompress(ge& o, u64 w0, u64 w1, u64 w2, u64 w3) {
  const fe one = fe_one();
  const fe y = fe_from_words(w0, w1, w2, w3);
  const u64 sign = w3 >> 63;
  const fe y2 = fe_sq(y);
  const fe u = fe_sub(y2, one);                       // y^2 - 1
  const fe v = fe_add(fe_mul(y2, fe_d()), one);       // d y^2 + 1
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe uv7 = fe_mul(fe_mul(fe_sq(v3), v), u);
  fe x = fe_mul(fe_mul(fe_pow22523(uv7), v3), u);
  const fe vx2 = fe_mul(fe_sq(x), v);
  const bool root_ok = fe_is_zero(fe_sub(vx2, u));
  const bool neg_ok = fe_is_zero(fe_add(vx2, u));
  x = fe_select(!root_ok && neg_ok, x, fe_mul(x, fe_sqrt_m1()));
  bool valid = root_ok || neg_ok;
  if (fe_is_zero(x) && sign) valid = false;           // the -0 encoding
  x = fe_select(fe_parity(x) != sign, x, fe_sub(fe_zero(), x));
  o.x = x;
  o.y = y;
  o.z = one;
  o.t = fe_mul(x, y);
  return valid;
}

E1_DEV ge ge_identity() {
  ge o;
  o.x = fe_zero(); o.y = fe_one(); o.z = fe_one(); o.t = fe_zero();
  return o;
}

E1_DEV ge_cached ge_cached_identity() {
  ge_cached o;
  o.ypx = fe_one(); o.ymx = fe_one(); o.z = fe_one(); o.t2d = fe_zero();
  return o;
}

E1_DEV ge_cached ge_to_cached(const ge& p) {
  ge_cached o;
  o.ypx = fe_add(p.y, p.x);
  o.ymx = fe_sub(p.y, p.x);
  o.z = p.z;
  o.t2d = fe_mul(p.t, fe_2d());
  return o;
}

// The complete addition's tail, from a, b, c and d = 2 Z1 Z2.
E1_DEV ge ge_add_tail(const fe& a, const fe& b, const fe& c, const fe& d) {
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  ge o;
  o.x = fe_mul(e, f); o.y = fe_mul(g, h); o.z = fe_mul(f, g); o.t = fe_mul(e, h);
  return o;
}

// The point operations are calls, not inlined: inlined, one ladder step
// is (8w + 15) field multiplies of ~340 instructions each, a loop body of
// 125-250 KB that the instruction cache cannot hold, and E1 ran 1.5x
// (B = 128) to 2.1x (B = 32768) slower at w = 4 (PERF.md).

// Complete addition (the oracle's point_add): 8 multiplies.
E1_CALL ge ge_add(const ge& p, const ge_cached& q) {
  const fe a = fe_mul(fe_sub(p.y, p.x), q.ymx);
  const fe b = fe_mul(fe_add(p.y, p.x), q.ypx);
  const fe c = fe_mul(p.t, q.t2d);
  const fe zz = fe_mul(p.z, q.z);
  return ge_add_tail(a, b, c, fe_add(zz, zz));
}

// The same with an affine operand (Z2 = 1): 7 multiplies.
E1_CALL ge ge_add(const ge& p, const ge_niels& q) {
  const fe a = fe_mul(fe_sub(p.y, p.x), q.ymx);
  const fe b = fe_mul(fe_add(p.y, p.x), q.ypx);
  const fe c = fe_mul(p.t, q.t2d);
  return ge_add_tail(a, b, c, fe_add(p.z, p.z));
}

// Dedicated doubling (dbl-2008-hwcd, a = -1): 4 squarings + 4 multiplies.
E1_CALL ge ge_dbl(const ge& p) {
  const fe a = fe_sq(p.x);
  const fe b = fe_sq(p.y);
  const fe zz = fe_sq(p.z);
  const fe c = fe_add(zz, zz);
  const fe g = fe_sub(b, a);
  const fe f = fe_sub(g, c);
  const fe h = fe_sub(fe_sub(fe_zero(), a), b);
  const fe e = fe_sub(fe_sub(fe_sq(fe_add(p.x, p.y)), a), b);
  ge o;
  o.x = fe_mul(e, f); o.y = fe_mul(g, h); o.z = fe_mul(f, g); o.t = fe_mul(e, h);
  return o;
}

E1_DEV ge ge_neg(const ge& p) {
  ge o = p;
  o.x = fe_sub(fe_zero(), p.x);
  o.t = fe_sub(fe_zero(), p.t);
  return o;
}

// Bits [bit, bit + W) of a 256-bit little-endian scalar (zero above 255).
template <int W>
E1_DEV int scalar_window(u64 w0, u64 w1, u64 w2, u64 w3, int bit) {
  const int word = bit >> 6, sh = bit & 63;
  const u64 lo = word == 0 ? w0 : word == 1 ? w1 : word == 2 ? w2 : w3;
  const u64 hi = word == 0 ? w1 : word == 1 ? w2 : word == 2 ? w3 : 0;
  u64 v = lo >> sh;
  if (sh + W > 64) v |= hi << (64 - sh);
  return (int)(v & ((1ULL << W) - 1));
}

// [i]B in niels form, row i of the host's table: [2^W][3][5] u64.
E1_DEV ge_niels load_base(const u64* btab, int i) {
  const u64* p = btab + 15 * i;
  ge_niels o;
  for (int l = 0; l < 5; ++l) {
    o.ypx.v[l] = E1_LDG(p + l);
    o.ymx.v[l] = E1_LDG(p + 5 + l);
    o.t2d.v[l] = E1_LDG(p + 10 + l);
  }
  return o;
}

// One signature: row = A | R | S | k as 16 little-endian u64 words.
// Returns a_ok & r_ok & ([S]B + [k](-A) == R).
template <int W>
E1_FN bool verify_one(const u64* row, const u64* btab) {
  ge a, r;
  const bool a_ok = ge_decompress(a, row[0], row[1], row[2], row[3]);
  const bool r_ok = ge_decompress(r, row[4], row[5], row[6], row[7]);
  // [j](-A) for j in [0, 2^W), in cached form: 1 + 9 (2^W - 2) multiplies.
  ge_cached chain[1 << W];
  chain[0] = ge_cached_identity();
  ge acc = ge_neg(a);
  chain[1] = ge_to_cached(acc);
  for (int j = 2; j < (1 << W); ++j) {
    acc = ge_add(acc, chain[1]);
    chain[j] = ge_to_cached(acc);
  }
  // MSB-first windows: W doublings, + [s_i]B, + [k_i](-A).
  ge q = ge_identity();
  constexpr int NW = (256 + W - 1) / W;
  for (int wi = NW - 1; wi >= 0; --wi) {
#pragma unroll
    for (int d = 0; d < W; ++d) q = ge_dbl(q);
    const int bit = wi * W;
    q = ge_add(q, load_base(
        btab, scalar_window<W>(row[8], row[9], row[10], row[11], bit)));
    q = ge_add(q, chain[scalar_window<W>(row[12], row[13], row[14], row[15],
                                          bit)]);
  }
  // Projective compare with R: 4 multiplies.
  const bool x_eq = fe_is_zero(fe_sub(fe_mul(q.x, r.z), fe_mul(r.x, q.z)));
  const bool y_eq = fe_is_zero(fe_sub(fe_mul(q.y, r.z), fe_mul(r.y, q.z)));
  return a_ok & r_ok & x_eq & y_eq;
}

}  // namespace e1

#ifdef __CUDACC__

constexpr int E1_THREADS = 128;

template <int W>
__global__ void __launch_bounds__(E1_THREADS)
ed25519_verify_kernel(const unsigned long long* __restrict__ rows,
                      const unsigned long long* __restrict__ btab,
                      uint8_t* __restrict__ out, int n) {
  const int i = blockIdx.x * E1_THREADS + threadIdx.x;
  if (i >= n) return;  // the ragged last block
  out[i] = e1::verify_one<W>(rows + 16 * (size_t)i, btab) ? 1 : 0;
}

// One field multiply per element: the unit whose SASS the bound counts.
__global__ void ed25519_fe_mul_probe_kernel(
    const unsigned long long* __restrict__ a,
    const unsigned long long* __restrict__ b, unsigned long long* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  e1::fe x, y;
  for (int l = 0; l < 5; ++l) {
    x.v[l] = a[5 * i + l];
    y.v[l] = b[5 * i + l];
  }
  const e1::fe z = e1::fe_mul(x, y);
  for (int l = 0; l < 5; ++l) o[5 * i + l] = z.v[l];
}

extern "C" {

// rows: uint8[n, 128] (A | R | S | k), 16-byte aligned; btab: u64[2^w][3][5]
// ([i]B in niels form); out: uint8[n].  1 <= w <= 6.
int ed25519_verify(const void* rows, const void* btab, void* out, int n, int w,
                   void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + E1_THREADS - 1) / E1_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* r = (const unsigned long long*)rows;
  const auto* t = (const unsigned long long*)btab;
  auto* o = (uint8_t*)out;
  switch (w) {
    case 1: ed25519_verify_kernel<1><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n); break;
    case 2: ed25519_verify_kernel<2><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n); break;
    case 3: ed25519_verify_kernel<3><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n); break;
    case 4: ed25519_verify_kernel<4><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n); break;
    case 5: ed25519_verify_kernel<5><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n); break;
    case 6: ed25519_verify_kernel<6><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, b, o: u64[n][5] radix-2^51 limbs; o = a * b, weakly reduced.
int ed25519_fe_mul_probe(const void* a, const void* b, void* o, int n,
                         void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  ed25519_fe_mul_probe_kernel<<<(n + 127) / 128, 128, 0,
                                (cudaStream_t)stream>>>(
      (const unsigned long long*)a, (const unsigned long long*)b,
      (unsigned long long*)o, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
