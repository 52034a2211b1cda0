"""Kernel E1's arithmetic (``csrc/ed25519_verify.cu``) built for the host
with g++ and held, on the CPU, to the one-thread functions, the native
library and the oracle.

The source compiles without nvcc: its arithmetic is plain C++ behind two
macros, and its host build exports ``e1_host_*`` entry points that run the
one-thread functions (``verify_one``, ``ge_dbl``, ``ge_add``,
``ge_to_cached``) and the team's flow (``verify_team``, ``team_dbl``,
``team_add``, ``team_to_cached``, ``team_chain``) with the four lanes held
side by side and run in lockstep (``HostTeam``): the same per-lane
functions and the same trades between lanes that the card runs through
shuffles.  Verdicts are compared at every window (w = 1 ... 6) on the RFC
8032 vectors and a seeded corruption sweep; the team's point after each
point operation and its chain of [j](-A) limb for limb against the
one-thread functions', and both against the oracle's integers."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from go_libp2p_pubsub_torch.crypto import ed25519_ref as ref
from go_libp2p_pubsub_torch.crypto import native, vectors
from go_libp2p_pubsub_torch.ops import cuda_ed25519
from go_libp2p_pubsub_torch.ops import ed25519 as ted

WINDOWS = cuda_ed25519.WINDOWS
P = ref.P
D2 = 2 * ref.D % P
OPS = {"dbl": 0, "add_cached": 1, "add_niels": 2, "to_cached": 3}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host arithmetic")
    out = str(tmp_path_factory.mktemp("e1_host") / "libe1_host.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", out, cuda_ed25519.SOURCE], check=True,
                   capture_output=True)
    so = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.e1_host_verify.argtypes = [vp, vp, vp, ci, ci, ci]
    so.e1_host_point_op.argtypes = [ci, vp, vp, vp, vp]
    so.e1_host_chain.argtypes = [vp, ci, vp, vp]
    for f in (so.e1_host_verify, so.e1_host_point_op, so.e1_host_chain):
        f.restype = ci
    return so


@pytest.fixture(scope="module")
def batch():
    """The RFC 8032 vectors and a 250-row corruption sweep: rows, host_ok,
    the native verdicts and the oracle's on the first 48."""
    pks, msgs, sigs, _ = vectors.corruption_sweep(250, 11)
    rp, rm, rs, _ = vectors.rfc8032_batch()
    pks, msgs, sigs = rp + pks, rm + msgs, rs + sigs
    rows, host_ok = ted.prepare_rows(pks, msgs, sigs, pad_to=len(pks))
    oracle = np.array([ref.verify(p, m, s) for p, m, s in
                       zip(pks[:48], msgs[:48], sigs[:48])])
    return (np.ascontiguousarray(rows), host_ok,
            native.verify_batch(pks, msgs, sigs), oracle)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _limbs(*vals) -> np.ndarray:
    return np.array([cuda_ed25519.to_limbs51(v) for v in vals], np.uint64)


def _ints(limbs: np.ndarray) -> list:
    return [sum(int(v) << (51 * i) for i, v in enumerate(row)) % P
            for row in np.asarray(limbs).reshape(-1, 5)]


def _verify(lib, rows, w, team) -> np.ndarray:
    out = np.zeros(len(rows), np.uint8)
    table = np.ascontiguousarray(cuda_ed25519.base_table_host(w))
    assert lib.e1_host_verify(_ptr(rows), _ptr(table), _ptr(out), len(rows),
                              w, team) == 0
    return out.astype(bool)


@pytest.mark.parametrize("w", WINDOWS)
def test_team_and_one_thread_verdicts_match_native_and_oracle(lib, batch, w):
    rows, host_ok, want, oracle = batch
    assert want.any() and not want.all()
    one = _verify(lib, rows, w, 0)
    team = _verify(lib, rows, w, 1)
    np.testing.assert_array_equal(team, one)  # raw, every row
    np.testing.assert_array_equal(team & host_ok, want)
    np.testing.assert_array_equal(one & host_ok, want)
    np.testing.assert_array_equal((team & host_ok)[:len(oracle)], oracle)


def _random_points(rng, n):
    """n points [s]B with a random projective scale: extended (X, Y, Z, T)
    integers, and their affine forms."""
    pts = []
    for _ in range(n):
        x, y, z, t = ref.point_mul(int(rng.integers(1, 2**62)) * 7919,
                                   ref.BASE)
        zi = pow(z, P - 2, P)
        ax, ay = x * zi % P, y * zi % P
        k = int.from_bytes(rng.bytes(32), "little") % P or 1
        pts.append(((ax * k % P, ay * k % P, k, ax * ay % P * k % P),
                    (ax, ay)))
    return pts


def _cached(p):
    x, y, z, t = p
    return ((y + x) % P, (y - x) % P, z, D2 * t % P)


def _point_op(lib, op, p_limbs, q_limbs):
    one = np.zeros(20, np.uint64)
    team = np.zeros(20, np.uint64)
    assert lib.e1_host_point_op(OPS[op], _ptr(p_limbs), _ptr(q_limbs),
                                _ptr(one), _ptr(team)) == 0
    return one, team


@pytest.mark.parametrize("op", list(OPS))
def test_team_point_op_equals_one_thread_limb_for_limb(lib, op):
    """Eight steps from a random point, each fed the last output (weakly
    reduced limbs): the team's four coordinates equal the one-thread
    function's limb for limb, and the value is the oracle's."""
    rng = np.random.default_rng(OPS[op] + 5)
    (p, _), (q, (qx, qy)) = _random_points(rng, 2)
    p_limbs = _limbs(*p)
    cur = p
    for _ in range(8):
        if op == "add_niels":
            q_limbs = _limbs((qy + qx) % P, (qy - qx) % P, D2 * qx * qy % P)
            want = ref.point_add(cur, (qx, qy, 1, qx * qy % P))
        elif op == "add_cached":
            q_limbs = _limbs(*_cached(q))
            want = ref.point_add(cur, q)
        else:
            q_limbs = _limbs(0)
            want = ref.point_add(cur, cur)
        one, team = _point_op(lib, op, p_limbs, q_limbs)
        np.testing.assert_array_equal(team, one)
        got = tuple(_ints(one))
        if op == "to_cached":
            ymx, ypx, z, t2d = got
            x, y, zz, t = cur
            assert (ymx, ypx, z, t2d) == ((y - x) % P, (y + x) % P, zz % P,
                                          D2 * t % P)
            return
        assert ref.point_equal(got, want)
        assert got[0] * got[1] % P == got[2] * got[3] % P  # XY = ZT
        p_limbs, cur = one.reshape(4, 5).copy(), got


@pytest.mark.parametrize("w", WINDOWS)
def test_team_chain_equals_one_thread_limb_for_limb(lib, w):
    """[j](-A) for j < 2^w in cached form, by the team and by the
    one-thread functions, for valid keys and an encoding with no root."""
    rng = np.random.default_rng(w)
    encs = [ref.public_key(rng.bytes(32)) for _ in range(3)]
    encs += vectors.no_root_encodings(1, w)
    for enc in encs:
        words = np.frombuffer(enc, np.uint64).copy()
        one = np.zeros((1 << w) * 20, np.uint64)
        team = np.zeros_like(one)
        ok = lib.e1_host_chain(_ptr(words), w, _ptr(one), _ptr(team))
        np.testing.assert_array_equal(team, one)
        try:
            a = ref.point_decompress(enc)
        except ValueError:
            assert ok == 0
            continue
        assert ok == 1
        neg_a = ((P - a[0]) % P, a[1], a[2], (P - a[3]) % P)
        for j, entry in enumerate(one.reshape(-1, 4, 5)):
            ymx, ypx, z, t2d = _ints(entry)
            x, y, zz, t = ref.point_mul(j, neg_a)
            assert ymx * zz % P == (y - x) * z % P
            assert ypx * zz % P == (y + x) * z % P
            assert t2d * zz % P == D2 * t * z % P
