"""The port covers the JAX package's whole public surface.

Every ``.py`` of ``go_libp2p_pubsub_tpu/`` and of ``go_libp2p_pubsub_torch/``
is read with ``ast`` (neither package is imported).  Each public top-level
function, class, class method and module-level name of the JAX package
must have a counterpart of the same name in the port's module of the same
relative path, or stand in ``NOT_COPIED`` with the reason the port does
not copy it.  A second check fails on a stale entry: a listed name the
JAX package no longer has, or one the port now has.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "go_libp2p_pubsub_tpu"
PORT_PKG = ROOT / "go_libp2p_pubsub_torch"

_SHARDING = "jax.sharding placement; parallel.mesh.PeerMesh stands in for it"
_LIMB_MAJOR = ("the TPU's limb-major layout; the port runs the batch-major "
               "*_bm forms (ed25519.default_batch_major)")

# (module path relative to the package, name) -> why the port has no such
# name.  The name "*" stands for the whole module.
NOT_COPIED = {
    ("ops/shard_compat.py", "*"): "a jax shim over shard_map's import path",
    ("ops/pallas_gossip.py", "*"):
        "the Pallas kernels K1/K2, ported as csrc/gossip_kernels.cu "
        "behind ops/cuda_gossip.py",
    ("parallel/mesh.py", "peer_dim_spec"): _SHARDING,
    ("parallel/mesh.py", "sharded_fn"): _SHARDING,
    ("parallel/mesh.py", "state_shardings"): _SHARDING,
    ("parallel/gossip_sharded.py", "ShardedGossipSub.shardings"): _SHARDING,
    ("utils/trace.py", "xla_trace"):
        "jax.profiler's trace; the port's is utils.trace.profiler_trace",
    **{("ops/ed25519.py", name): _LIMB_MAJOR for name in (
        "fe_add", "fe_canon", "fe_eq", "fe_is_zero", "fe_mul", "fe_norm",
        "fe_parity", "fe_pow_const", "fe_sq", "fe_sub",
        "pt_add", "pt_dbl", "pt_decompress", "pt_eq", "pt_identity",
        "pt_neg", "pt_select", "pt_select_stacked",
        "straus_double_scalarmult", "windowed_double_scalarmult",
    )},
}

# Files a whole-module entry's counterpart lives in.
REPLACED_BY = {
    "ops/pallas_gossip.py": ("csrc/gossip_kernels.cu", "ops/cuda_gossip.py"),
}


def _public(name: str) -> bool:
    return not any(part.startswith("_") for part in name.split("."))


def public_names(path: pathlib.Path) -> set:
    """Public top-level functions, classes, class methods (``Cls.meth``)
    and module-level assigned names of one source file."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(
                f"{node.name}.{sub.name}" for sub in node.body
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if _public(n)}


def _modules(pkg: pathlib.Path):
    return sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                  if "build" not in p.relative_to(pkg).parts)


JAX_MODULES = _modules(JAX_PKG)


def test_both_packages_are_found():
    assert len(JAX_MODULES) > 50
    assert (PORT_PKG / "__init__.py").exists()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = PORT_PKG / module
    if (module, "*") in NOT_COPIED:
        for rel in REPLACED_BY.get(module, ()):
            assert (PORT_PKG / rel).exists(), (module, rel)
        return
    assert port.exists(), f"{module}: no counterpart module in the port"
    have = public_names(port)
    missing = sorted(
        name for name in public_names(JAX_PKG / module) - have
        if (module, name) not in NOT_COPIED)
    assert not missing, (
        f"{module}: the port lacks {missing}; port them or list each in "
        "NOT_COPIED with its reason")


@pytest.mark.parametrize("entry", sorted(NOT_COPIED), ids="::".join)
def test_not_copied_entry_is_current(entry):
    module, name = entry
    assert NOT_COPIED[entry].strip(), entry
    ref = JAX_PKG / module
    assert ref.exists(), f"{module}: gone from the JAX package"
    port = PORT_PKG / module
    if name == "*":
        assert not port.exists(), f"{module}: the port now has it"
        return
    assert name in public_names(ref), f"{entry}: gone from the JAX package"
    assert not port.exists() or name not in public_names(port), (
        f"{entry}: the port now has it; drop the entry")
