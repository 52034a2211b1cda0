"""The port's float arithmetic held to the reference's XLA CPU backend bit
for bit where plain torch would differ: the order of a full f32 sum at
every width (``ops/reduce_order``, vectorised rows included) and the
flush of subnormal floats (``ops/fma.ftz``).

Both sides take the same inputs, made from a seed with numpy; every
comparison is of float32 bits (NaN equal to NaN).  The hybrid's cases are
the two faults these helpers close: a narrow-slot ``loss_ewma_mean``
(K < 16) and a loss estimate that decays across the smallest normal
float32.
"""

import glob
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from go_libp2p_pubsub_tpu.models.gossipsub import GossipSub as JG  # noqa: E402
from go_libp2p_pubsub_tpu.models.hybrid import HybridGossipSub as JH  # noqa: E402
from go_libp2p_pubsub_tpu.ops import histogram as jhist  # noqa: E402
from go_libp2p_pubsub_tpu.ops import loss_estimator as jloss  # noqa: E402
from go_libp2p_pubsub_tpu.utils.metrics import gossip_metrics as j_metrics  # noqa: E402
from go_libp2p_pubsub_torch import bridge  # noqa: E402
from go_libp2p_pubsub_torch.models import coded_trace as CT  # noqa: E402
from go_libp2p_pubsub_torch.models.gossipsub import GossipSub as TG  # noqa: E402
from go_libp2p_pubsub_torch.models.hybrid import HybridGossipSub as TH  # noqa: E402
from go_libp2p_pubsub_torch.ops import histogram as thist  # noqa: E402
from go_libp2p_pubsub_torch.ops import loss_estimator as tloss  # noqa: E402
from go_libp2p_pubsub_torch.ops import reduce_order  # noqa: E402
from go_libp2p_pubsub_torch.ops.fma import FLT_MIN, ftz  # noqa: E402
from go_libp2p_pubsub_torch.utils.metrics import gossip_metrics as t_metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jsum = jax.jit(jnp.sum)


def _same(a, b, what):
    """Equal dtype, shape and bits; NaN equals NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        nan = np.isnan(a) & np.isnan(b)
        a = np.where(nan, 0, a.view(np.int32))
        b = np.where(nan, 0, b.view(np.int32))
    np.testing.assert_array_equal(b, a, err_msg=what)


def _wide(rs, shape, zeros=0.3):
    """Signed values over eight decades, some zero."""
    x = rs.standard_normal(shape) * np.exp(rs.uniform(-9, 9, shape))
    return (x * (rs.random(shape) >= zeros)).astype(np.float32)


def _near_flt_min(rs, shape, below=23, above=4):
    """Positive values from 2**-below to 2**above times FLT_MIN."""
    return (FLT_MIN * np.exp2(rs.uniform(-below, above, shape))).astype(
        np.float32)


# -- the order of a full sum --------------------------------------------------

_GRID = ([(n, k) for n in (1, 7, 31, 32, 33, 64, 100, 589, 2000)
          for k in (1, 2, 3, 4, 5, 8, 12, 15, 16, 24, 31, 33)]
         + [(1,), (31,), (100,), (2000,), (100_000,)]
         + [(4, 64, 4), (3, 20, 5), (33, 2, 8), (63, 7, 2), (2, 63, 63),
            (40, 3, 64)])


@pytest.mark.parametrize("shape", _GRID, ids=lambda s: "x".join(map(str, s)))
def test_xla_sum_and_sparse_sum_match_jitted_sum(shape):
    """Row loops of 2 to 8 columns vectorise (4 or 8 lanes), windows
    padded at their low end stay scalar, a pad of one row is peeled: every
    case adds as ``jnp.sum`` under ``jax.jit`` does."""
    rs = np.random.default_rng(int(np.prod(shape)) + len(shape))
    for _ in range(3):
        x = _wide(rs, shape)
        ref = np.asarray(_jsum(x))
        _same(ref, reduce_order.xla_sum(torch.from_numpy(x)).numpy(),
              f"xla_sum {shape}")
        idx = np.flatnonzero((x != 0) | np.signbit(x))
        _same(ref, reduce_order.sparse_sum(shape, idx, x.reshape(-1)[idx]),
              f"sparse_sum {shape}")


@pytest.mark.parametrize("cols", range(1, 11))
def test_xla_sum_rows_by_cols_sweep(cols):
    """Every row count a loop can have (2 to 32) at ``cols`` columns: the
    table of ``reduce_order.vector_width``."""
    rs = np.random.default_rng(cols)
    for rows in range(2, 33):
        x = _wide(rs, (rows, cols), zeros=0.0)
        lanes = reduce_order.vector_width(rows, cols)
        _same(_jsum(x), reduce_order.xla_sum(torch.from_numpy(x)).numpy(),
              f"{rows} x {cols} ({lanes} lanes)")


def ir_vector_widths(out_dir, rows=range(2, 33), cols=range(1, 11)):
    """{(rows, cols): lanes} as LLVM gives them to the row loop of
    ``jnp.sum`` over each [rows, cols] f32 array: read from the optimised
    IR that XLA's CPU backend dumps (a child process with
    ``--xla_dump_to=out_dir``); 1 where the loop stays scalar."""
    shapes = [(r, c) for r in rows for c in cols]
    code = ("import jax, jax.numpy as jnp, numpy as np\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            f"for s in {shapes!r}:\n"
            "    jax.jit(jnp.sum)(np.ones(s, np.float32))\n")
    env = dict(os.environ, XLA_FLAGS=f"--xla_dump_to={out_dir}")
    subprocess.run([sys.executable, "-c", code], env=env, check=True)
    out = {}
    for hlo in glob.glob(os.path.join(out_dir, "*.before_optimizations.txt")):
        shape = re.search(r"f32\[(\d+),(\d+)\]", open(hlo).read())
        ll = glob.glob(hlo.replace(".before_optimizations.txt",
                                   ".wrapped_reduce_kernel_module"
                                   ".ir-with-opt.ll"))
        if not shape or not ll:
            continue
        width = re.search(r"<(\d+) x float>", open(ll[0]).read())
        out[tuple(map(int, shape.groups()))] = int(
            width.group(1)) if width else 1
    return out


def test_vector_width_is_llvms_choice(tmp_path):
    """``reduce_order.vector_width`` is the width in XLA's own IR for every
    row loop a reduction can hold (rows 2 to 32, 1 to 10 columns)."""
    got = ir_vector_widths(str(tmp_path))
    assert len(got) == 31 * 10
    differ = {rc: w for rc, w in got.items()
              if w != reduce_order.vector_width(*rc)}
    assert not differ, f"(rows, cols): LLVM's lanes off the table: {differ}"


_HYB = dict(n_peers=64, msg_window=16, heartbeat_steps=4, gen_size=4)


def _hybrid_pair(k, ewma=None):
    """Both models at seed 3 with five publishes; ``ewma`` (numpy) is
    carried into the reference state before the bridge."""
    kw = dict(_HYB, n_slots=k, conn_degree=min(6, k - 1))
    jm, tm = JH(**kw), TH(device="cpu", **kw)
    js = jm.init(3)
    for src, slot in ((0, 0), (5, 1), (9, 2), (11, 3), (20, 4)):
        js = jm.publish(js, jnp.int32(src), jnp.int32(slot),
                        jnp.asarray(True))
    if ewma is not None:
        js = js._replace(loss_ewma=jnp.asarray(ewma))
    return jm, tm, js, bridge.hybrid_state_from_numpy(js, "cpu")


def _same_hybrid_run(jm, tm, js, ts, steps, what):
    jf, jrec = jm.rollout(js, steps, record=True)
    tf, trec = tm.rollout(ts, steps, record=True)
    la, lb = CT.flatten(jf), CT.flatten(bridge.hybrid_state_to_numpy(tf))
    assert la.keys() == lb.keys()
    for name in la:
        _same(la[name], lb[name], f"{what}: state {name}")
    assert set(jrec) == set(trec)
    for name in jrec:
        _same(jrec[name], trec[name].numpy(), f"{what}: record {name}")
    return jf, jrec


@pytest.mark.parametrize("k", [4, 8])
def test_hybrid_narrow_slots_match_reference(k):
    """Seed 3, N = 64, one message word, ``gen_size`` 4, decimation 2:
    the run whose ``loss_ewma_mean`` left the reference at round 9 when
    the sum modelled no vectorised rows."""
    jm, tm, js, ts = _hybrid_pair(k)
    _, jrec = _same_hybrid_run(jm, tm, jm.set_ingress_loss(js, 2),
                               tm.set_ingress_loss(ts, 2), 24, f"K={k}")
    assert int(np.asarray(jrec["coded_edges"])[-1]) > 0


# -- the flush of subnormal floats --------------------------------------------


def test_ftz_flushes_subnormals_only():
    below = np.nextafter(np.float32(FLT_MIN), np.float32(0))
    vals = np.array([1e-39, -1e-39, 1e-45, -1e-45, 0.0, -0.0, FLT_MIN,
                     -FLT_MIN, below, 1.0, np.inf, -np.inf, np.nan],
                    np.float32)
    out = ftz(torch.from_numpy(vals)).numpy()
    want = vals.copy()
    want[[0, 2, 8]], want[[1, 3]] = 0.0, -0.0
    _same(want, out, "ftz")
    # As XLA's CPU arithmetic flushes, sign kept.
    ref = np.asarray(jax.jit(lambda x: x * np.float32(0.25))(
        np.array([2e-38, -2e-38, 8e-38], np.float32)))
    _same(ref, ftz(torch.tensor([2e-38, -2e-38, 8e-38]) * 0.25).numpy(),
          "x * 0.25")


_SUB, _NORMAL = np.float32(1e-39), np.float32(2e-38)


@pytest.mark.parametrize("case", [
    ("x * 0.25 flushes, sign kept", lambda x, y: x * np.float32(0.25),
     (np.float32(-2e-38), _NORMAL), np.float32(-0.0)),
    ("x + y reads x as zero", lambda x, y: x + y, (_SUB, _NORMAL), _NORMAL),
    ("x * 0.75 + y reads x as zero", lambda x, y: x * np.float32(0.75) + y,
     (_SUB, _NORMAL), _NORMAL),
    ("a fused result flushes", lambda x, y: x * np.float32(0.5) + y,
     (np.float32(3e-38), np.float32(-1.4e-38)), np.float32(0.0)),
    ("x == 0 is true", lambda x, y: (x == 0).astype(jnp.float32),
     (_SUB, _NORMAL), np.float32(1.0)),
    ("max(x, 0) is 0", lambda x, y: jnp.maximum(x, 0.0), (_SUB, _NORMAL),
     np.float32(0.0)),
    ("a select keeps x", lambda x, y: jnp.where(y > 0, x, y),
     (_SUB, _NORMAL), _SUB),
    ("negation keeps x", lambda x, y: -x, (_SUB, _NORMAL), -_SUB),
], ids=lambda c: c[0])
def test_reference_flush_rule(case):
    """What ``ops/fma.ftz`` stands for: XLA's CPU arithmetic reads a
    subnormal operand as zero and stores a subnormal result as zero of its
    sign (FTZ and DAZ); data movement passes a subnormal on."""
    _, fn, args, want = case
    _same(np.asarray(want, np.float32), jax.jit(fn)(*args), case[0])


@pytest.mark.parametrize("fabric", ["clean", "decimation"])
def test_loss_ewma_across_flt_min_matches_reference(fabric):
    """The estimate carried in from 2**-6 to 2**3 times FLT_MIN: clean
    expected rounds decay it across FLT_MIN, where the reference stores
    zero; quiet edges keep the subnormals they hold."""
    ewma = _near_flt_min(np.random.default_rng(5), (64, 8), 6, 3)
    assert (ewma < FLT_MIN).any() and (ewma >= FLT_MIN).any()
    jm, tm, js, ts = _hybrid_pair(8, ewma)
    if fabric == "decimation":
        js, ts = jm.set_ingress_loss(js, 2), tm.set_ingress_loss(ts, 2)
    jf, _ = _same_hybrid_run(jm, tm, js, ts, 6, fabric)
    le = np.asarray(jf.loss_ewma)
    if fabric == "clean":
        assert ((le == 0) & (ewma != 0)).any()      # flushed on the way
    assert ((le != 0) & (np.abs(le) < FLT_MIN)).any()  # kept when quiet


def test_ewma_fold_and_latch_read_subnormals_as_zero():
    rs = np.random.default_rng(11)
    shape = (200, 8)
    ew = _near_flt_min(rs, shape, 23, 2) * np.where(
        rs.random(shape) < 0.3, -1, 1).astype(np.float32)
    exp_, obs = rs.random(shape) < 0.7, rs.random(shape) < 0.5
    coded = rs.random(shape) < 0.5
    te = (torch.from_numpy(ew), torch.from_numpy(exp_), torch.from_numpy(obs))
    for alpha in (0.25, 0.5):
        ref = jax.jit(jloss.ewma_update, static_argnums=3)(
            ew, exp_, obs, alpha)
        _same(ref, tloss.ewma_update(*te, alpha).numpy(), f"fold {alpha}")
    for hi, lo in ((0.35, 0.0), (0.5, FLT_MIN / 2)):
        ref = jax.jit(jloss.hysteresis_switch, static_argnums=(2, 3))(
            ew, coded, hi, lo)
        _same(ref, tloss.hysteresis_switch(
            te[0], torch.from_numpy(coded), hi, lo).numpy(), f"latch {lo}")


def _subnormal_case(kind, rs, n):
    if kind == "all_subnormal":
        return _near_flt_min(rs, n, 23, 0)
    if kind == "mixed":
        v = _near_flt_min(rs, n, 23, 4)
        v[rs.random(n) < 0.2] = 0.0
        normal = rs.random(n) < 0.2
        v[normal] = rs.normal(0, 1e-37, int(normal.sum()))
        return v
    v = _near_flt_min(rs, n, 23, 2) * np.where(rs.random(n) < 0.5, -1, 1)
    v = v.astype(np.float32)
    v[rs.random(n) < 0.1] = 0.0
    v[rs.random(n) < 0.1] = -0.0
    return v


@pytest.mark.parametrize("kind", ["all_subnormal", "mixed", "signed"])
def test_masked_quantiles_on_subnormals_match_reference(kind):
    for seed in range(8):
        rs = np.random.default_rng(seed)
        n = int(rs.integers(1, 400))
        v = _subnormal_case(kind, rs, n)
        mask = rs.random(n) < rs.uniform(0.3, 1.0)
        for qs in ((0.5,), (0.1, 0.5, 0.9), tuple(rs.random(5)), (0.0, 1.0)):
            ref = jhist.masked_quantiles(jnp.asarray(v), jnp.asarray(mask),
                                         qs)
            out = thist.masked_quantiles(torch.from_numpy(v),
                                         torch.from_numpy(mask), qs)
            _same(ref, out.numpy(), f"{kind} seed {seed} {qs}")


@pytest.mark.parametrize("shape", [(1,), (40,), (31, 4), (64, 8), (100, 3),
                                   (2000, 2), (7, 33), (3, 4, 5)])
def test_sums_and_means_of_subnormals_match_reference(shape):
    """Subnormal elements count as zero, a partial sum or a mean that
    falls below FLT_MIN is stored as zero; one element alone is passed
    on."""
    mean = jax.jit(JG.masked_mean)
    for seed in range(6):
        rs = np.random.default_rng(seed)
        x = _near_flt_min(rs, shape, 10, 4) * np.where(
            rs.random(shape) < 0.5, -1, 1)
        x = (x * (rs.random(shape) >= (seed % 2) * 0.5)).astype(np.float32)
        _same(_jsum(x), reduce_order.xla_sum(torch.from_numpy(x)).numpy(),
              f"xla_sum {shape} seed {seed}")
        mask = rs.random(shape) < 0.5
        idx = np.flatnonzero(mask)
        _same(mean(x, mask), reduce_order.masked_mean(
            shape, idx, x.reshape(-1)[idx], int(mask.sum())),
            f"masked_mean {shape} seed {seed}")


@pytest.mark.parametrize("k", [4, 8])
def test_gossip_metrics_at_narrow_slots_match_reference(k):
    """``gossip_metrics``' two nanmeans at K < 16, after a few rounds that
    give the scores values."""
    kw = dict(n_peers=100, n_slots=k, conn_degree=k - 1, msg_window=32)
    ga, gt = JG(use_pallas=False, **kw), TG(device="cpu", **kw)
    sa = ga.init(seed=2)
    st = bridge.state_from_jax(sa, device="cpu")
    for s in range(5):
        sa = ga.publish(sa, jnp.int32(s * 13), jnp.int32(s),
                        jnp.asarray(s != 3))
        st = gt.publish(st, s * 13, s, s != 3)
    sa, _ = ga.rollout(sa, 12, record=False)
    st, _ = gt.rollout(st, 12, record=False)
    ma, mt = j_metrics(sa), t_metrics(st)
    assert sorted(ma) == sorted(mt)
    assert float(ma["score_mean"]) != 0.0
    for name in ma:
        _same(ma[name], mt[name].numpy(), name)


if __name__ == "__main__":
    # Print the row loop's lanes as XLA's CPU backend compiles them:
    #   JAX_PLATFORMS=cpu python tests/test_torch_exact_order.py
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        widths = ir_vector_widths(d)
    print("rows\\cols " + " ".join(f"{c:>2}" for c in range(1, 11)))
    for r in range(2, 33):
        print(f"{r:>9} " + " ".join(f"{widths[(r, c)]:>2}"
                                    for c in range(1, 11)))
