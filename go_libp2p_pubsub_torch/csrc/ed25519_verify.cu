// Kernel E1: batched ed25519 verification on Hopper (sm_90a), a team of
// four lanes per signature.
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
// 64x64->128-bit limb products each at w = 5 (fe_mul_count in
// ops/cuda_ed25519.py).  The arithmetic:
// - field elements are radix 2^51 in five u64 limbs (the representation of
//   the host library, native/ed25519/ed25519.cpp, whose arithmetic this
//   rewrites for the device): 25 limb products a multiply, where the
//   twin's 22 limbs of 12 bits need 484;
// - the decompression square root takes the fixed addition chain for
//   2^252 - 3 (251 squarings + 11 multiplies, not 253 + ~250);
// - the ladder retires w bits of both scalars a step: w dedicated
//   doublings (dbl-2008-hwcd, 8 multiplies), one add of [i]B from a table
//   the host makes from the oracle (global memory, niels form, 7
//   multiplies) and one add of [j](-A) from a chain of 2^w points the
//   signature builds (local memory, cached form, 8 multiplies).  Two adds
//   a step instead of the twin's 4^w joint grid; verdict-identical,
//   because the group arithmetic is exact;
// - no data-dependent branch: the sqrt(-1) fix and the sign flip are
//   selects, every step adds (identity entries absorb zero windows), so a
//   warp never diverges on the data and the multiply count does not
//   depend on it.
//
// What holds a verification back is latency: ~3.7k dependent multiplies,
// and a small batch (the 128-signature window) fills few SMs.  So four
// consecutive lanes of a warp verify one signature, eight to a warp, in
// the 4-way form of the extended-coordinate formulas (Hisil, Wong, Carter,
// Dawson 2008) -- the same formulas, spread over lanes:
// - lane c owns coordinate c of the running point (X, Y, Z, T) and
//   component c of every add operand, in the order (Y-X, Y+X, Z, 2dT)
//   (a niels operand: y-x, y+x, 1, 2dxy), so lanes 2 and 3 multiply their
//   own coordinate;
// - a doubling or an add is two rounds of one fe_mul a lane: the four
//   products of the formula's first half, traded by shuffle, then the four
//   output coordinates; ge_to_cached is one round.  The critical path at
//   w = 5 is ~1,095 multiplies instead of 3,685;
// - lanes 0 and 2 decompress A while lanes 1 and 3 decompress R, then
//   trade coordinates; the chain keeps component c of [j](-A) on lane c
//   (40 B an entry); lane c loads component c of the base table's niels
//   entry; the scalar windows are the team's;
// - the per-lane work is pure functions of (lane, operands) that select by
//   lane rather than branch on it, so the warp runs one instruction
//   stream, and the shuffles only move values between those functions.  A
//   Team says where a lane's values live: on the card each lane holds its
//   own and trades by __shfl_sync; the host build's HostTeam holds all
//   four and runs the lanes in lockstep through the same flow
//   (tests/test_torch_e1_host.py);
// - a lane past the batch's end verifies the last row and skips the store:
//   a lane that left early would make the team's shuffles undefined.
// The bound does not change with the team: fe_mul_count(w) multiplies a
// signature; the team's second decompression and its shuffles are not
// counted as work.
// One thread a signature (verify_one) stays as the arm for large batches:
// the team does ~19% more lane-multiplies a signature (4 x 1,095 against
// 3,685 at w = 5) plus its shuffles, which costs more than the shorter
// chain saves once a batch fills the card, as a verifier's batches of
// 32,768 do (bench.py's device curve); the wrapper picks the arm by batch
// size (ONE_THREAD_FROM in ops/cuda_ed25519.py, measured).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/cuda_ed25519.py:build).  The C entry points launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().
// Without nvcc (g++ -x c++) the file builds the host entry points instead
// (e1_host_*), which run the one-thread functions and the team on the CPU.

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

// -- The team: four lanes a signature -----------------------------------------

// By lane: a on lane 0, b on lane 1, c2 on lane 2, d on lane 3.
E1_DEV fe fe_lane(int c, const fe& a, const fe& b, const fe& c2, const fe& d) {
  fe o;
  for (int i = 0; i < 5; ++i)
    o.v[i] = c == 0 ? a.v[i] : c == 1 ? b.v[i] : c == 2 ? c2.v[i] : d.v[i];
  return o;
}

// Coordinate c of a point: X, Y, Z, T.
E1_DEV fe ge_coord(int c, const ge& p) { return fe_lane(c, p.x, p.y, p.z, p.t); }

// Lane c's coordinate of the identity, and its component of the identity's
// cached form.
E1_DEV fe identity_lane(int c) {
  return fe_lane(c, fe_zero(), fe_one(), fe_one(), fe_zero());
}
E1_DEV fe cached_identity_lane(int c) {
  return fe_lane(c, fe_one(), fe_one(), fe_one(), fe_zero());
}

// ge_neg: -X on lane 0, -T on lane 3.
E1_DEV fe neg_lane(int c, const fe& own) {
  return fe_select(c == 0 || c == 3, own, fe_sub(fe_zero(), own));
}

// ge_to_cached, lane c's component of (Y-X, Y+X, Z, 2dT); `mate` is lane
// c^1's coordinate (Y on lane 0, X on lane 1).
E1_DEV fe cached_lane(int c, const fe& own, const fe& mate) {
  const fe t2d = fe_mul(own, fe_2d());
  return fe_lane(c, fe_sub(mate, own), fe_add(own, mate), own, t2d);
}

// An add's first round: (Y-X)(Y-X)', (Y+X)(Y+X)', Z Z', T (2dT)' on lanes
// 0 ... 3.  An affine operand (Z' = 1) leaves lane 2 its own Z.
template <bool AFFINE>
E1_DEV fe add_round1(int c, const fe& own, const fe& mate, const fe& op) {
  const fe prod =
      fe_mul(fe_lane(c, fe_sub(mate, own), fe_add(own, mate), own, own), op);
  return fe_select(AFFINE && c == 2, prod, own);
}

// The second round of both: X3 = e f, Y3 = g h, Z3 = f g, T3 = e h.
E1_DEV fe round2_lane(int c, const fe& e, const fe& f, const fe& g,
                      const fe& h) {
  return fe_mul(fe_lane(c, e, g, f, e), fe_lane(c, f, h, g, h));
}

// ge_add_tail, from the first round's a, b, zz and c.
E1_DEV fe add_round2(int c, const fe& a, const fe& b, const fe& zz,
                     const fe& cc) {
  const fe d = fe_add(zz, zz);
  return round2_lane(c, fe_sub(b, a), fe_sub(d, cc), fe_add(d, cc),
                     fe_add(b, a));
}

// A doubling's first round: X^2, Y^2, Z^2, (X+Y)^2 on lanes 0 ... 3.
E1_DEV fe dbl_round1(int c, const fe& own, const fe& x, const fe& y) {
  return fe_sq(fe_select(c == 3, own, fe_add(x, y)));
}

// ge_dbl's second half, from X^2, Y^2, Z^2 and (X+Y)^2.
E1_DEV fe dbl_round2(int c, const fe& a, const fe& b, const fe& zz,
                     const fe& s) {
  const fe cc = fe_add(zz, zz);
  const fe g = fe_sub(b, a);
  const fe f = fe_sub(g, cc);
  const fe h = fe_sub(fe_sub(fe_zero(), a), b);
  const fe e = fe_sub(fe_sub(s, a), b);
  return round2_lane(c, e, f, g, h);
}

// Lane c's component of [i]B from the host's niels table (rows of y+x,
// y-x, 2dxy): y-x, y+x, 1, 2dxy.  Lane 2 loads nothing.
E1_DEV fe load_base_lane(int c, const u64* btab, int i) {
  fe o = fe_one();
  if (c != 2) {
    const u64* p = btab + 15 * i + (c == 0 ? 5 : c == 1 ? 0 : 10);
    for (int l = 0; l < 5; ++l) o.v[l] = E1_LDG(p + l);
  }
  return o;
}

// Lanes 0 and 2 decompress A, lanes 1 and 3 R: coordinates c and c^1 of
// the lane's point, and whether its encoding is valid.
struct lane_point {
  fe own, mate;
  int ok;
};
E1_DEV lane_point decompress_lane(int c, const u64* row) {
  const u64* w = row + 4 * (c & 1);
  ge p;
  lane_point o;
  o.ok = ge_decompress(p, w[0], w[1], w[2], w[3]);
  o.own = ge_coord(c, p);
  o.mate = ge_coord(c ^ 1, p);
  return o;
}

// The projective compare's products: X r.z, Y r.z, r.x Z, r.y Z on lanes
// 0 ... 3; r_xy is r.x on lane 2 and r.y on lane 3.
E1_DEV fe compare_lane(int c, const fe& q, const fe& r_xy, const fe& rz,
                       const fe& qz) {
  return fe_mul(fe_select(c >= 2, q, r_xy), fe_select(c >= 2, rz, qz));
}

// Where a lane's values live.  Team::reg<T> is what one lane holds of a
// value that every lane of the team has its own of; each() runs a per-lane
// function on the lane's operands; from() trades: on lane c, the value
// that lane src(c) holds.
#ifdef __CUDACC__
struct Team {  // on the card: a lane holds its own value
  template <class T>
  using reg = T;
  int lane;  // 0 ... 3
  template <class F, class... A>
  E1_DEV auto each(F f, const A&... a) const {
    return f(lane, a...);
  }
  template <class S>
  E1_DEV fe from(const fe& v, S src) const {
    const int s = src(lane);
    fe o;
#pragma unroll
    for (int l = 0; l < 5; ++l)
      o.v[l] = __shfl_sync(0xffffffffu, v.v[l], s, 4);
    return o;
  }
  template <class S>
  E1_DEV int from(int v, S src) const {
    return __shfl_sync(0xffffffffu, v, src(lane), 4);
  }
};
#else
struct HostTeam {  // the host build: all four lanes' values, in lockstep
  template <class T>
  struct reg {
    T v[4];
  };
  template <class F, class... A>
  auto each(F f, const reg<A>&... a) const
      -> reg<decltype(f(0, a.v[0]...))> {
    reg<decltype(f(0, a.v[0]...))> o;
    for (int c = 0; c < 4; ++c) o.v[c] = f(c, a.v[c]...);
    return o;
  }
  template <class T, class S>
  reg<T> from(const reg<T>& v, S src) const {
    reg<T> o;
    for (int c = 0; c < 4; ++c) o.v[c] = v.v[src(c)];
    return o;
  }
};
#endif

template <class Tm, class T>
using lane_t = typename Tm::template reg<T>;

// A per-lane function as an argument of each().
#define E1_LANE(fn) [](int c, const auto&... a) { return fn(c, a...); }

// On every lane, the four lanes' values in lane order.
template <class Tm>
E1_DEV void team_gather(Tm t, const lane_t<Tm, fe>& v, lane_t<Tm, fe> (&o)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = t.from(v, [k](int) { return k; });
}

// ge_dbl: two rounds.
template <class Tm>
E1_CALL lane_t<Tm, fe> team_dbl(Tm t, lane_t<Tm, fe> p) {
  const auto x = t.from(p, [](int) { return 0; });
  const auto y = t.from(p, [](int) { return 1; });
  lane_t<Tm, fe> s[4];
  team_gather(t, t.each(E1_LANE(dbl_round1), p, x, y), s);
  return t.each(E1_LANE(dbl_round2), s[0], s[1], s[2], s[3]);
}

// ge_add with a cached operand, or (AFFINE) a niels one: two rounds.
template <bool AFFINE, class Tm>
E1_CALL lane_t<Tm, fe> team_add(Tm t, lane_t<Tm, fe> p, lane_t<Tm, fe> op) {
  const auto mate = t.from(p, [](int c) { return c ^ 1; });
  lane_t<Tm, fe> s[4];
  team_gather(t, t.each(E1_LANE(add_round1<AFFINE>), p, mate, op), s);
  return t.each(E1_LANE(add_round2), s[0], s[1], s[2], s[3]);
}

// ge_to_cached: one round.
template <class Tm>
E1_CALL lane_t<Tm, fe> team_to_cached(Tm t, lane_t<Tm, fe> p) {
  return t.each(E1_LANE(cached_lane), p,
                t.from(p, [](int c) { return c ^ 1; }));
}

// [j](-A) for j in [0, 2^W) in cached form: 1 + 3 (2^W - 2) rounds.
template <int W, class Tm>
E1_DEV void team_chain(Tm t, const lane_t<Tm, fe>& neg_a,
                       lane_t<Tm, fe> (&chain)[1 << W]) {
  chain[0] = t.each(E1_LANE(cached_identity_lane));
  chain[1] = team_to_cached(t, neg_a);
  lane_t<Tm, fe> acc = neg_a;
  for (int j = 2; j < (1 << W); ++j) {
    acc = team_add<false>(t, acc, chain[1]);
    chain[j] = team_to_cached(t, acc);
  }
}

// verify_one by a team: on lane 0, a_ok & r_ok & ([S]B + [k](-A) == R).
template <int W, class Tm>
E1_FN lane_t<Tm, int> verify_team(Tm t, const u64* row, const u64* btab) {
  using F = lane_t<Tm, fe>;
  const auto dec = t.each([row](int c) { return decompress_lane(c, row); });
  const F own = t.each([](int, const lane_point& d) { return d.own; }, dec);
  const F got = t.from(
      t.each([](int, const lane_point& d) { return d.mate; }, dec),
      [](int c) { return c ^ 1; });
  const auto ok = t.each([](int, const lane_point& d) { return d.ok; }, dec);
  const auto ok_mate = t.from(ok, [](int c) { return c ^ 1; });
  // Coordinate c of A and of R on lane c.
  const F a = t.each(
      [](int c, const fe& o, const fe& g) { return fe_select(c & 1, o, g); },
      own, got);
  const F r = t.each(
      [](int c, const fe& o, const fe& g) { return fe_select(c & 1, g, o); },
      own, got);
  F chain[1 << W];
  team_chain<W>(t, t.each(E1_LANE(neg_lane), a), chain);
  // MSB-first windows: W doublings, + [s_i]B, + [k_i](-A).
  F q = t.each(E1_LANE(identity_lane));
  constexpr int NW = (256 + W - 1) / W;
  for (int wi = NW - 1; wi >= 0; --wi) {
#pragma unroll
    for (int d = 0; d < W; ++d) q = team_dbl(t, q);
    const int bit = wi * W;
    const int i = scalar_window<W>(row[8], row[9], row[10], row[11], bit);
    q = team_add<true>(
        t, q, t.each([btab, i](int c) { return load_base_lane(c, btab, i); }));
    q = team_add<false>(
        t, q, chain[scalar_window<W>(row[12], row[13], row[14], row[15], bit)]);
  }
  // The projective compare with R: one round; then x_eq on lane 0, y_eq
  // on lane 1.
  const F prod = t.each(E1_LANE(compare_lane), q,
                        t.from(r, [](int c) { return c & 1; }),
                        t.from(r, [](int) { return 2; }),
                        t.from(q, [](int) { return 2; }));
  const auto eq = t.each(
      [](int, const fe& x, const fe& y) { return (int)fe_is_zero(fe_sub(x, y)); },
      prod, t.from(prod, [](int c) { return c ^ 2; }));
  return t.each([](int, int e, int ey, int o, int om) { return e & ey & o & om; },
                eq, t.from(eq, [](int) { return 1; }), ok, ok_mate);
}

}  // namespace e1

#ifdef __CUDACC__

constexpr int E1_LANES = 4;  // lanes a signature
// Threads a block, both arms; cuda_ed25519.THREADS has the block sweep's
// times.  tools/e1_sweep.py rebuilds this file with -DE1_THREADS=n.
#ifndef E1_THREADS
#define E1_THREADS 128
#endif

template <int W>
__global__ void __launch_bounds__(E1_THREADS)
ed25519_verify_kernel(const unsigned long long* __restrict__ rows,
                      const unsigned long long* __restrict__ btab,
                      uint8_t* __restrict__ out, int n) {
  const long long sig =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / E1_LANES;
  // A lane past the end verifies the last row, so every lane of the warp
  // reaches every shuffle; only the store is skipped.
  const long long i = sig < n ? sig : n - 1;
  const e1::Team t{(int)(threadIdx.x % E1_LANES)};
  const int ok = e1::verify_team<W>(t, rows + 16 * (size_t)i, btab);
  if (t.lane == 0 && sig < n) out[sig] = ok ? 1 : 0;
}

// One thread a signature (verify_one).
template <int W>
__global__ void __launch_bounds__(E1_THREADS)
ed25519_verify_one_kernel(const unsigned long long* __restrict__ rows,
                          const unsigned long long* __restrict__ btab,
                          uint8_t* __restrict__ out, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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

template <int W>
static void launch(bool team, int blocks, cudaStream_t s,
                   const unsigned long long* r, const unsigned long long* t,
                   uint8_t* o, int n) {
  if (team)
    ed25519_verify_kernel<W><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n);
  else
    ed25519_verify_one_kernel<W><<<blocks, E1_THREADS, 0, s>>>(r, t, o, n);
}

extern "C" {

// rows: uint8[n, 128] (A | R | S | k), 16-byte aligned; btab: u64[2^w][3][5]
// ([i]B in niels form); out: uint8[n].  1 <= w <= 6.  lanes: 4 (the team)
// or 1 (one thread a signature), the arm the caller picked.
int ed25519_verify(const void* rows, const void* btab, void* out, int n, int w,
                   int lanes, void* stream) {
  if (n <= 0 || (lanes != 1 && lanes != E1_LANES))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      ((long long)n * lanes + E1_THREADS - 1) / E1_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool team = lanes == E1_LANES;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* r = (const unsigned long long*)rows;
  const auto* t = (const unsigned long long*)btab;
  auto* o = (uint8_t*)out;
  switch (w) {
    case 1: launch<1>(team, (int)blocks, s, r, t, o, n); break;
    case 2: launch<2>(team, (int)blocks, s, r, t, o, n); break;
    case 3: launch<3>(team, (int)blocks, s, r, t, o, n); break;
    case 4: launch<4>(team, (int)blocks, s, r, t, o, n); break;
    case 5: launch<5>(team, (int)blocks, s, r, t, o, n); break;
    case 6: launch<6>(team, (int)blocks, s, r, t, o, n); break;
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

#else  // the host build: the one-thread functions and the team on the CPU

namespace e1 {

typedef HostTeam::reg<fe> team_fe;

E1_DEV fe fe_load(const u64* p) {
  fe o;
  for (int l = 0; l < 5; ++l) o.v[l] = p[l];
  return o;
}
E1_DEV void fe_store(u64* p, const fe& a) {
  for (int l = 0; l < 5; ++l) p[l] = a.v[l];
}
// u64[4][5] (X, Y, Z, T) <-> the point, and <-> the team's coordinates.
E1_DEV ge ge_load(const u64* p) {
  ge o;
  o.x = fe_load(p); o.y = fe_load(p + 5); o.z = fe_load(p + 10);
  o.t = fe_load(p + 15);
  return o;
}
E1_DEV void ge_store(u64* p, const ge& a) {
  fe_store(p, a.x); fe_store(p + 5, a.y); fe_store(p + 10, a.z);
  fe_store(p + 15, a.t);
}
E1_DEV team_fe team_load(const u64* p) {
  team_fe o;
  for (int c = 0; c < 4; ++c) o.v[c] = fe_load(p + 5 * c);
  return o;
}
E1_DEV void team_store(u64* p, const team_fe& a) {
  for (int c = 0; c < 4; ++c) fe_store(p + 5 * c, a.v[c]);
}
// A cached point as u64[4][5] in the team's order (Y-X, Y+X, Z, 2dT).
E1_DEV void cached_store(u64* p, const ge_cached& a) {
  fe_store(p, a.ymx); fe_store(p + 5, a.ypx); fe_store(p + 10, a.z);
  fe_store(p + 15, a.t2d);
}

template <int W>
void host_verify(const u64* rows, const u64* btab, uint8_t* out, int n,
                 bool team) {
  for (int i = 0; i < n; ++i)
    out[i] = team ? verify_team<W>(HostTeam{}, rows + 16 * i, btab).v[0] != 0
                  : verify_one<W>(rows + 16 * i, btab);
}

template <int W>
int host_chain(const u64* row, u64* one, u64* team) {
  ge a;
  const bool ok = ge_decompress(a, row[0], row[1], row[2], row[3]);
  ge_cached chain[1 << W];
  chain[0] = ge_cached_identity();
  ge acc = ge_neg(a);
  chain[1] = ge_to_cached(acc);
  for (int j = 2; j < (1 << W); ++j) {
    acc = ge_add(acc, chain[1]);
    chain[j] = ge_to_cached(acc);
  }
  const HostTeam t;
  team_fe tchain[1 << W];
  team_fe ta;
  for (int c = 0; c < 4; ++c) ta.v[c] = ge_coord(c, a);
  team_chain<W>(t, t.each(E1_LANE(neg_lane), ta), tchain);
  for (int j = 0; j < (1 << W); ++j) {
    cached_store(one + 20 * j, chain[j]);
    team_store(team + 20 * j, tchain[j]);
  }
  return ok;
}

}  // namespace e1

extern "C" {

// Verdicts of rows uint8[n, 128] at window w (1 ... 6): verify_one (team
// = 0) or verify_team with the four lanes in lockstep (team = 1).
int e1_host_verify(const void* rows, const void* btab, void* out, int n,
                   int w, int team) {
  const auto* r = (const e1::u64*)rows;
  const auto* t = (const e1::u64*)btab;
  auto* o = (uint8_t*)out;
  switch (w) {
    case 1: e1::host_verify<1>(r, t, o, n, team); break;
    case 2: e1::host_verify<2>(r, t, o, n, team); break;
    case 3: e1::host_verify<3>(r, t, o, n, team); break;
    case 4: e1::host_verify<4>(r, t, o, n, team); break;
    case 5: e1::host_verify<5>(r, t, o, n, team); break;
    case 6: e1::host_verify<6>(r, t, o, n, team); break;
    default: return -1;
  }
  return 0;
}

// One point operation on p (u64[4][5]: X, Y, Z, T) by the one-thread
// function and by the team, each result as u64[4][5] (X, Y, Z, T).  op 0:
// ge_dbl; op 1: ge_add with q a cached point, u64[4][5] (Y+X, Y-X, Z,
// 2dT); op 2: ge_add with q a niels point, u64[3][5] (y+x, y-x, 2dxy), the
// base table's row layout; op 3: ge_to_cached (results in the team's
// order, Y-X, Y+X, Z, 2dT).
int e1_host_point_op(int op, const void* p, const void* q, void* one,
                     void* team) {
  using namespace e1;
  const auto* pp = (const u64*)p;
  const auto* qq = (const u64*)q;
  const ge a = ge_load(pp);
  const team_fe ta = team_load(pp);
  const HostTeam t;
  switch (op) {
    case 0:
      ge_store((u64*)one, ge_dbl(a));
      team_store((u64*)team, team_dbl(t, ta));
      return 0;
    case 1: {
      ge_cached c;
      c.ypx = fe_load(qq); c.ymx = fe_load(qq + 5); c.z = fe_load(qq + 10);
      c.t2d = fe_load(qq + 15);
      team_fe tc;
      tc.v[0] = c.ymx; tc.v[1] = c.ypx; tc.v[2] = c.z; tc.v[3] = c.t2d;
      ge_store((u64*)one, ge_add(a, c));
      team_store((u64*)team, team_add<false>(t, ta, tc));
      return 0;
    }
    case 2:
      ge_store((u64*)one, ge_add(a, load_base(qq, 0)));
      team_store((u64*)team,
                 team_add<true>(t, ta, t.each([qq](int c) {
                   return load_base_lane(c, qq, 0);
                 })));
      return 0;
    case 3:
      cached_store((u64*)one, ge_to_cached(a));
      team_store((u64*)team, team_to_cached(t, ta));
      return 0;
    default:
      return -1;
  }
}

// The chain of [j](-A), j in [0, 2^w), for A from its 32-byte encoding
// (four little-endian u64 words): one and team are u64[2^w][4][5] in the
// team's order (Y-X, Y+X, Z, 2dT).  Returns whether A decompressed.
int e1_host_chain(const void* a_words, int w, void* one, void* team) {
  const auto* r = (const e1::u64*)a_words;
  auto* o = (e1::u64*)one;
  auto* t = (e1::u64*)team;
  switch (w) {
    case 1: return e1::host_chain<1>(r, o, t);
    case 2: return e1::host_chain<2>(r, o, t);
    case 3: return e1::host_chain<3>(r, o, t);
    case 4: return e1::host_chain<4>(r, o, t);
    case 5: return e1::host_chain<5>(r, o, t);
    case 6: return e1::host_chain<6>(r, o, t);
    default: return -1;
  }
}

}  // extern "C"

#endif  // __CUDACC__
