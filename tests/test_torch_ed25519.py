"""The port's ed25519 verifier (``go_libp2p_pubsub_torch/ops/ed25519.py``,
the plain PyTorch version of kernel E1) held against the JAX package's
``ops/ed25519.py`` on the CPU.

Every intermediate is int32 limbs, so the comparisons are exact: the
constants array for array, the batch-major field ops, points, tables and
both ladders limb for limb, and ``verify_batch``'s verdicts on the RFC 8032
vectors and a corruption mix for both ladders, every window and both
``batch_major`` values.  Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.crypto import ed25519_ref as tref
from go_libp2p_pubsub_torch.crypto import native, vectors
from go_libp2p_pubsub_torch.ops import cuda_ed25519
from go_libp2p_pubsub_torch.ops import ed25519 as ted
from go_libp2p_pubsub_tpu.crypto import ed25519_ref as jref
from go_libp2p_pubsub_tpu.ops import ed25519 as jed


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain verifier is thousands of small ops; with several test
    workers on the same cores, torch's intra-op thread pools spin against
    each other and run it ~10x slower.  One thread per op keeps it fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _eq(port, ref) -> None:
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _eq_point(port, ref) -> None:
    for p, r in zip(port, ref):
        _eq(p, r)


def _signed_limbs(rng, b):
    """Redundant signed limbs, |limb| < 2^12: legal field-op inputs."""
    return rng.integers(-4095, 4096, (ted.LIMBS, b)).astype(np.int32)


def _encodings(rng, n):
    """Valid keys, then a y with no root, the -0 encoding, y = 1 and a
    small-order point: [n + 4, 32] uint8."""
    seeds = [rng.bytes(32) for _ in range(n)]
    encs = [tref.public_key(s) for s in seeds]
    encs += vectors.no_root_encodings(1, 3)
    encs += [(1 | 1 << 255).to_bytes(32, "little"), (1).to_bytes(32, "little"),
             vectors.small_order_encodings()[3]]
    return np.frombuffer(b"".join(encs), np.uint8).reshape(len(encs), 32)


def _decompressed(rows):
    y, sign = ted._enc_to_limbs_and_sign(rows)
    tp, tv = ted.pt_decompress_bm(_t(y.T), _t(sign))
    jp, jv = jed.pt_decompress_bm(jnp.asarray(y.T), jnp.asarray(sign))
    return tp, tv, jp, jv


# -- constants --------------------------------------------------------------


def test_constants_match_reference():
    for name in ("FE_D", "FE_2D", "FE_BX", "FE_BY", "FE_BT", "FE_SQRT_M1",
                 "FE_P", "_ONE_HOT", "_POW_EXP_BITS"):
        a, b = getattr(ted, name), getattr(jed, name)
        assert a.dtype == b.dtype, name
        _eq(a, b)
    assert (ted.LIMBS, ted.BITS, ted.RADIX, ted.CONV, ted.FOLD) == (
        jed.LIMBS, jed.BITS, jed.RADIX, jed.CONV, jed.FOLD)
    for name in ("P", "L", "D", "_BX", "_BY", "BASE", "IDENT"):
        assert getattr(tref, name) == getattr(jref, name), name


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6])
def test_base_window_consts_match_reference(w):
    for a, b in zip(ted._base_window_consts(w), jed._base_window_consts(w)):
        assert a.dtype == b.dtype
        _eq(a, b)


@pytest.mark.parametrize("w", [1, 4])
def test_kernel_base_table_is_the_oracle_comb(w):
    """E1's [i]B table (niels form, radix 2^51) holds y+x, y-x and 2dxy of
    the oracle's [i]B."""
    table = cuda_ed25519.base_table_host(w)
    assert table.shape == (1 << w, 3, 5)
    p = tref.P
    for i, row in enumerate(table):
        x, y, z, t = tref.point_mul(i, tref.BASE)
        zi = pow(z, p - 2, p)
        x, y = x * zi % p, y * zi % p
        got = [sum(int(v) << (51 * k) for k, v in enumerate(c)) for c in row]
        assert got == [(y + x) % p, (y - x) % p, 2 * tref.D * x * y % p]


# -- field ops --------------------------------------------------------------


def test_field_ops_match_reference_limb_for_limb():
    rng = np.random.default_rng(0)
    a, b = _signed_limbs(rng, 16), _signed_limbs(rng, 16)
    # canonical inputs too, and the corner values 0, 1, p - 1, p, p + 1
    corners = np.stack([ted._int_to_limbs(v % (1 << 264)) for v in (
        0, 1, tref.P - 1, tref.P, tref.P + 1, 2 * tref.P, (1 << 255) - 1)], 1)
    a = np.concatenate([a, corners], 1)
    b = np.concatenate([b, corners[:, ::-1]], 1)
    ta, tb, ja, jb = _t(a), _t(b), jnp.asarray(a), jnp.asarray(b)
    for name in ("fe_mul_bm", "fe_add_bm", "fe_sub_bm"):
        out = getattr(ted, name)(ta, tb)
        assert out.dtype == torch.int32
        _eq(out, getattr(jed, name)(ja, jb))
    for name in ("fe_sq_bm", "_carry_once_bm", "fe_norm_bm", "fe_canon_bm",
                 "fe_is_zero_bm", "fe_parity_bm"):
        _eq(getattr(ted, name)(ta), getattr(jed, name)(ja))
    _eq(ted.fe_eq_bm(ta, tb), jed.fe_eq_bm(ja, jb))
    # chains of products stay exact
    x, y = ta, ja
    for _ in range(8):
        x, y = ted.fe_mul_bm(x, tb), jed.fe_mul_bm(y, jb)
    _eq(x, y)


def test_fe_mul_equals_field_product():
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(32), "little") % tref.P for _ in range(8)]
    a = np.stack([ted._int_to_limbs(v) for v in vals], 1)
    b = a[:, ::-1].copy()
    out = ted.fe_canon_bm(ted.fe_mul_bm(_t(a), _t(b))).numpy()
    for k, (x, y) in enumerate(zip(vals, vals[::-1])):
        _eq(out[:, k], ted._int_to_limbs(x * y % tref.P))


def test_fe_pow_const_matches_reference():
    rng = np.random.default_rng(2)
    a = _signed_limbs(rng, 6)
    _eq(ted.fe_pow_const_bm(_t(a), ted._POW_EXP_BITS),
        jed.fe_pow_const_bm(jnp.asarray(a), jed._POW_EXP_BITS))


# -- points -----------------------------------------------------------------


def test_decompress_matches_reference():
    rows = _encodings(np.random.default_rng(3), 5)
    tp, tv, jp, jv = _decompressed(rows)
    _eq_point(tp, jp)
    _eq(tv, jv)
    assert list(tv.numpy()) == [True] * 5 + [False, False, True, True]


def test_point_ops_match_reference():
    rows = _encodings(np.random.default_rng(4), 6)[:6]
    p, _, jp, _ = _decompressed(rows)
    q = ted.Point(*[v.roll(1, 1) for v in p])
    jq = jed.Point(*[jnp.roll(v, 1, 1) for v in jp])
    _eq_point(ted.pt_add_bm(p, q), jed.pt_add_bm(jp, jq))
    _eq_point(ted.pt_dbl_bm(p), jed.pt_dbl_bm(jp))
    _eq_point(ted.pt_neg_bm(p), jed.pt_neg_bm(jp))
    _eq(ted.pt_eq_bm(ted.pt_dbl_bm(p), ted.pt_add_bm(p, p)),
        jed.pt_eq_bm(jed.pt_dbl_bm(jp), jed.pt_add_bm(jp, jp)))
    assert ted.pt_eq_bm(ted.pt_dbl_bm(p), ted.pt_add_bm(p, p)).all()
    stack = ted.Point(*[torch.stack([a, b]) for a, b in zip(p, q)])
    jstack = jed.Point(*[jnp.stack([a, b]) for a, b in zip(jp, jq)])
    idx = np.array([0, 1, 1, 0, 1, 0], np.int32)
    _eq_point(ted.pt_select_stacked_bm(stack, _t(idx)),
              jed.pt_select_stacked_bm(jstack, jnp.asarray(idx)))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6])
def test_scalar_windows_match_reference(w):
    rng = np.random.default_rng(w)
    bits = rng.integers(0, 2, (5, 256)).astype(np.int32)
    _eq(ted._scalar_windows(_t(bits), w),
        jed._scalar_windows(jnp.asarray(bits), w))


@pytest.mark.parametrize("w", [1, 2])
def test_joint_table_matches_reference(w):
    rows = _encodings(np.random.default_rng(5), 3)[:3]
    p, _, jp, _ = _decompressed(rows)
    _eq_point(ted._joint_table_bm(ted.pt_neg_bm(p), w),
              jed._joint_table_bm(jed.pt_neg_bm(jp), w))


@pytest.mark.parametrize("ladder", ["straus", "windowed"])
def test_ladders_match_reference(ladder):
    rng = np.random.default_rng(6)
    rows = _encodings(rng, 4)[:4]
    p, _, jp, _ = _decompressed(rows)
    s_bits = rng.integers(0, 2, (4, 256)).astype(np.int32)
    k_bits = rng.integers(0, 2, (4, 256)).astype(np.int32)
    if ladder == "straus":
        out = ted.straus_double_scalarmult_bm(
            _t(s_bits), _t(k_bits), ted.pt_neg_bm(p))
        ref = jed.straus_double_scalarmult_bm(
            jnp.asarray(s_bits), jnp.asarray(k_bits), jed.pt_neg_bm(jp))
    else:
        out = ted.windowed_double_scalarmult_bm(
            _t(s_bits), _t(k_bits), ted.pt_neg_bm(p), 2)
        ref = jed.windowed_double_scalarmult_bm(
            jnp.asarray(s_bits), jnp.asarray(k_bits), jed.pt_neg_bm(jp), 2)
    _eq_point(out, ref)


# -- verify_batch -----------------------------------------------------------


def _verdict_batch():
    """RFC 8032 (6 rows) + a 26-row corruption sweep: 32 rows."""
    pks, msgs, sigs, _ = vectors.rfc8032_batch()
    sp, sm, ss, _ = vectors.corruption_sweep(26, 9)
    return pks + sp, msgs + sm, sigs + ss


@pytest.mark.parametrize("ladder,window,batch_major", [
    ("straus", None, True), ("straus", None, False),
    ("windowed", 1, True), ("windowed", 2, True), ("windowed", 2, False),
    ("windowed", 3, True),
])
def test_verify_batch_matches_reference(ladder, window, batch_major):
    pks, msgs, sigs = _verdict_batch()
    kw = dict(ladder=ladder, window=window, batch_major=batch_major)
    got = ted.verify_batch(pks, msgs, sigs, device="cpu", **kw)
    want = jed.verify_batch(pks, msgs, sigs, **kw)
    assert got.dtype == bool and got.shape == (32,)
    _eq(got, want)
    _eq(got, native.verify_batch(pks, msgs, sigs))
    assert got.any() and not got.all()


def test_verify_batch_window4_matches_reference():
    pks, msgs, sigs, want = vectors.rfc8032_batch()
    pks, msgs, sigs = pks[2:], msgs[2:], sigs[2:]   # 4 rows: 2 good, 2 bad
    got = ted.verify_batch(pks, msgs, sigs, window=4, device="cpu")
    _eq(got, jed.verify_batch(pks, msgs, sigs, window=4))
    _eq(got, want[2:])


def test_verify_batch_argument_errors_match_reference():
    pks, msgs, sigs, _ = vectors.rfc8032_batch()
    one = (pks[:1], msgs[:1], sigs[:1])
    for kw, match in (
        (dict(ladder="montgomery"), "unknown ladder"),
        (dict(ladder="straus", window=3), "window only applies"),
        (dict(ladder="windowed", window=0), "outside the practical range"),
        (dict(ladder="windowed", window=7), "outside the practical range"),
    ):
        with pytest.raises(ValueError, match=match):
            jed.verify_batch(*one, **kw)
        with pytest.raises(ValueError, match=match):
            ted.verify_batch(*one, device="cpu", **kw)
    for fn in (jed.verify_batch, lambda *a, **k: ted.verify_batch(
            *a, device="cpu", **k)):
        with pytest.raises(ValueError, match="length mismatch"):
            fn(pks[:2], msgs[:1], sigs[:2])
        with pytest.raises(ValueError, match="smaller than batch"):
            fn(pks[:3], msgs[:3], sigs[:3], pad_to=2)
        assert fn([], [], []).shape == (0,)


def test_defaults_follow_the_device():
    assert ted.default_batch_major() is True
    assert ted.default_ladder() == jed.default_ladder() == "windowed"
    assert ted.default_window("cpu") == jed.default_window() == 2
    assert 1 <= ted.default_window("cuda") <= 6
    assert ted.default_window() == ted.default_window("cuda")


def test_prepare_rows_layout_and_host_checks():
    pks, msgs, sigs, kinds = vectors.corruption_sweep(48, 4)
    rows, host_ok = ted.prepare_rows(pks, msgs, sigs)
    assert rows.shape == (64, ted.ROW_BYTES) and rows.dtype == np.uint8
    assert not rows[48:].any()
    for i in range(48):
        assert rows[i, :32].tobytes() == pks[i]
        assert rows[i, 32:96].tobytes() == sigs[i]
        k = int.from_bytes(rows[i, 96:].tobytes(), "little")
        assert k == tref._sha512_int(sigs[i][:32], pks[i], msgs[i]) % tref.L
        assert host_ok[i] == (kinds[i] not in (
            "malleable_s", "r_y_ge_p", "a_y_ge_p")), kinds[i]


def test_wrapper_runs_the_plain_version_for_cpu_rows():
    pks, msgs, sigs, want = vectors.rfc8032_batch()
    rows, host_ok = ted.prepare_rows(pks, msgs, sigs)
    cuda_ed25519.reset_launches()
    out = cuda_ed25519.verify(_t(rows), "windowed", 2)
    assert cuda_ed25519.verify.launches == 0
    assert out.dtype == torch.bool and out.device.type == "cpu"
    _eq(out.numpy()[:6] & host_ok, want)
    _eq(out, ted.verify_rows(_t(rows), "windowed", 2))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_ed25519_cuda.py")
    pks, msgs, sigs, _ = vectors.rfc8032_batch()
    with pytest.raises((RuntimeError, AssertionError)):
        ted.verify_batch(pks, msgs, sigs)
    assert cuda_ed25519.fe_mul_count(4) < cuda_ed25519.fe_mul_count(1)
