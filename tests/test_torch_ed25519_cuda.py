"""Kernel E1 (batched ed25519 verification, ``csrc/ed25519_verify.cu``)
held against the native C++ library and its plain PyTorch version (the
twin, run on the same card) on an NVIDIA card: the RFC 8032 vectors and a
seeded corruption sweep at every window, ragged batch sizes (a team, a
warp or a block split), both arms (the team of four lanes and one thread
a signature) at the batch where the wrapper switches between them, the
kernel's field multiply against integers, the launch count, and the
wrapper's argument checks.

These tests need the card and ``nvcc``; elsewhere they skip.  This file
imports only torch and the port, so it runs where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_ed25519_cuda.py -m cuda``
(``--noconftest``: the repository's conftest imports JAX)."""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_torch.crypto import native, vectors
from go_libp2p_pubsub_torch.crypto import ed25519_ref as ref
from go_libp2p_pubsub_torch.ops import cuda_ed25519
from go_libp2p_pubsub_torch.ops import ed25519 as ted


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _batch(n=250, seed=11):
    pks, msgs, sigs, _ = vectors.corruption_sweep(n, seed)
    rp, rm, rs, _ = vectors.rfc8032_batch()
    return pks + rp, msgs + rm, sigs + rs


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6])
def test_e1_matches_native_and_twin(w):
    dev = _cuda()
    pks, msgs, sigs = _batch()
    want = native.verify_batch(pks, msgs, sigs)
    assert want.any() and not want.all()
    got = ted.verify_batch(pks, msgs, sigs, window=w, device=dev)
    np.testing.assert_array_equal(got, want)
    # The device part alone, against the twin on the same card, on the
    # rows the host passed (the others are ANDed away).
    rows, host_ok = ted.prepare_rows(pks, msgs, sigs)
    rows = torch.from_numpy(rows).to(dev)
    raw = cuda_ed25519.verify(rows, "windowed", w).cpu().numpy()
    twin = ted.verify_rows(rows, "windowed", min(w, 4)).cpu().numpy()
    n = len(pks)
    np.testing.assert_array_equal(raw[:n][host_ok], twin[:n][host_ok])
    np.testing.assert_array_equal(raw[:n] & host_ok, want)


@pytest.mark.cuda
def test_e1_straus_equals_oracle_on_rfc_vectors():
    dev = _cuda()
    pks, msgs, sigs, want = vectors.rfc8032_batch()
    for ladder in ("straus", "windowed"):
        got = ted.verify_batch(pks, msgs, sigs, ladder=ladder, device=dev)
        np.testing.assert_array_equal(got, want)
    oracle = [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    np.testing.assert_array_equal(oracle, want)


_SPB = cuda_ed25519.sigs_per_block(1)  # the team's


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 7, 9, 31, 33, 127, 129, 16 * _SPB - 1,
                               16 * _SPB + 1])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6])
def test_e1_ragged_batches(n, w):
    """No padding (``pad_to=n``): a batch that splits a team (4 lanes), a
    warp (8 signatures) or a block leaves its last lanes past the end;
    they verify the last row and store nothing."""
    dev = _cuda()
    pks, msgs, sigs = _batch(n=n, seed=n)
    pks, msgs, sigs = pks[:n], msgs[:n], sigs[:n]
    want = native.verify_batch(pks, msgs, sigs)
    cuda_ed25519.reset_launches()
    got = ted.verify_batch(pks, msgs, sigs, pad_to=n, window=w, device=dev)
    assert cuda_ed25519.verify.launches == 1
    np.testing.assert_array_equal(got, want)
    rows, host_ok = ted.prepare_rows(pks, msgs, sigs, pad_to=n)
    rows = torch.from_numpy(rows).to(dev)
    raw = cuda_ed25519.verify(rows, "windowed", w).cpu().numpy()
    twin = ted.verify_rows(rows, "windowed", min(w, 4)).cpu().numpy()
    np.testing.assert_array_equal(raw & host_ok, twin & host_ok)
    np.testing.assert_array_equal(raw[host_ok], twin[host_ok])


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6])
def test_e1_both_arms_at_the_crossover(w):
    """Below ``ONE_THREAD_FROM`` signatures the wrapper launches the team,
    from there up one thread a signature: at the crossover and one either
    side both arms give the native verdicts and the same raw ones, and
    ``verify_batch`` launches E1 once."""
    dev = _cuda()
    x = cuda_ed25519.ONE_THREAD_FROM
    pks, msgs, sigs = _batch()
    reps = -(-(x + 1) // len(pks))
    pks, msgs, sigs = pks * reps, msgs * reps, sigs * reps
    for b in (x - 1, x, x + 1):
        want = native.verify_batch(pks[:b], msgs[:b], sigs[:b])
        rows, host_ok = ted.prepare_rows(pks[:b], msgs[:b], sigs[:b],
                                         pad_to=b)
        rows = torch.from_numpy(rows).to(dev)
        team = cuda_ed25519._verify_arm(rows, w,
                                        cuda_ed25519.LANES).cpu().numpy()
        one = cuda_ed25519._verify_arm(rows, w, 1).cpu().numpy()
        np.testing.assert_array_equal(team, one)
        np.testing.assert_array_equal(team & host_ok, want)
        assert cuda_ed25519.launch_lanes(b) == (
            cuda_ed25519.LANES if b < x else 1)
        cuda_ed25519.reset_launches()
        got = ted.verify_batch(pks[:b], msgs[:b], sigs[:b], pad_to=b,
                               window=w, device=dev)
        assert cuda_ed25519.verify.launches == 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_e1_counts_launches_and_cpu_rows_never_reach_it():
    dev = _cuda()
    pks, msgs, sigs, want = vectors.rfc8032_batch()
    rows, host_ok = ted.prepare_rows(pks, msgs, sigs)
    cuda_ed25519.reset_launches()
    out = cuda_ed25519.verify(torch.from_numpy(rows).to(dev), "windowed", 4)
    assert out.device.type == "cuda"
    assert cuda_ed25519.verify.launches == 1
    cpu = cuda_ed25519.verify(torch.from_numpy(rows), "windowed", 2)
    assert cpu.device.type == "cpu"
    assert cuda_ed25519.verify.launches == 1
    np.testing.assert_array_equal(out.cpu().numpy(), cpu.numpy())
    np.testing.assert_array_equal(cpu.numpy()[:len(pks)] & host_ok, want)


@pytest.mark.cuda
def test_e1_field_multiply_matches_integers():
    dev = _cuda()
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % ref.P
            for _ in range(512)] + [0, 1, ref.P - 1, ref.P - 2, 19, 2**255 - 20]
    a, b = vals, vals[::-1]
    limbs = lambda vs: torch.tensor(  # noqa: E731
        [cuda_ed25519.to_limbs51(v) for v in vs], dtype=torch.int64,
        device=dev)
    out = cuda_ed25519.fe_mul_probe(limbs(a), limbs(b)).cpu().numpy()
    for x, y, row in zip(a, b, out):
        got = sum(int(v) << (51 * i) for i, v in enumerate(row.tolist()))
        assert got % ref.P == x * y % ref.P


@pytest.mark.cuda
def test_e1_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _cuda()
    rows = torch.zeros((4, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        cuda_ed25519.verify(rows.to(torch.int32), "windowed", 4)
    with pytest.raises(ValueError):
        cuda_ed25519.verify(rows[:, :64], "windowed", 4)
    with pytest.raises(ValueError):
        cuda_ed25519.verify(torch.zeros((4 * 128 + 1,), dtype=torch.uint8,
                                        device=dev)[1:].view(4, 128),
                            "windowed", 4)
    with pytest.raises(ValueError):
        cuda_ed25519.verify(rows, "windowed", 7)
    with pytest.raises(ValueError):
        cuda_ed25519.verify(rows[:0], "windowed", 4)
    for lanes in (0, 2, 8):
        with pytest.raises(ValueError):
            cuda_ed25519._verify_arm(rows, 4, lanes)
    with pytest.raises(ValueError):
        cuda_ed25519._verify_arm(rows.cpu(), 4, cuda_ed25519.LANES)
