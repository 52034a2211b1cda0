"""Peer meshes over ``torch.distributed``: the sharded rollout's collectives.

Port of the JAX package's ``parallel/mesh.py``.  There the peer dimension
of every state array is sharded over a ``jax.sharding.Mesh`` and XLA's
GSPMD inserts the collectives.  PyTorch has no GSPMD: the sharded model
runs one process per rank (SPMD), each rank ``r`` of ``R`` holds rows
``[r * B, (r + 1) * B)`` of every peer-dim leaf (``B = N / R``) and the
replicated leaves whole, and every read across peer rows is an explicit
exchange through a :class:`PeerMesh`:

- :meth:`PeerMesh.all_gather_rows` -- the whole [N, ...] table;
- :meth:`PeerMesh.gather` -- ``table[clip(idx)]`` at global row ids, by an
  all-gather or, with ``ring`` set, by the split-gather ring
  (``ops.gossip_packed.ring_gather_rows``);
- :meth:`PeerMesh.sum` / :meth:`min` / :meth:`max` / :meth:`any` --
  integer all-reduces (a float sum over ranks would add in another order
  than the reference, so floats are refused);
- :meth:`PeerMesh.gather_canonical` -- a whole state in canonical order,
  for checks.

Every collective is called by every rank in the same order; nothing that
depends on a rank's own data decides whether one runs.  A world of one is
a real group and goes through the same calls.  Cards use NCCL (one rank a
card); the CPU tests use gloo.  Ranks of a gloo group that hold CUDA
tensors (several ranks on one card, where NCCL refuses) move the ring's
point-to-point blocks through host buffers (gloo's send/recv take CPU
tensors); the bytes staged are counted in ``PeerMesh.staged``.

:func:`state_blocks` / :func:`shard_state` are the twin of the reference's
``state_shardings`` / ``shard_state``: the exhaustive, by-name field
classification, then a rank's block of a whole state.  :func:`run_ranks`
spawns a group (``spawn`` start method: a parent with JAX or CUDA live
must not fork), pins one thread a rank and fails loudly on a timeout or a
rank's exception.
"""

from __future__ import annotations

import copy
import os
import socket
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gossip_packed import ring_gather_rows
from ..ops.graphs import decode_index_plane, encode_index_plane, take_rows

PEER_AXIS = "peers"

# dtypes a collective carries as they are; the others travel as a wider
# integer (int16 / uint16 index planes) or as bytes (bool).
_WIRE = {torch.uint8, torch.int8, torch.int32, torch.int64, torch.float32,
         torch.float64}


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    if x.dtype in _WIRE:
        return x.contiguous()
    if x.dtype == torch.bool:
        return x.contiguous().view(torch.uint8)
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32)
    if x.dtype == torch.int16:
        return x.to(torch.int32)
    raise TypeError(f"no wire form for {x.dtype}")


def _from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype == dtype:
        return x
    if dtype == torch.bool:
        return x.view(torch.bool)
    if dtype == torch.uint16:
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


class PeerMesh:
    """A rank's view of the peer axis: the process group, its rank and
    world, the block of ``B = N / world`` rows it owns, the rank's
    ``torch.device`` (the current card by default; a CPU group passes
    ``device="cpu"``), the peer axis name, and the collectives.

    ``ring`` selects the split-gather ring for :meth:`gather`, the
    sharded model's ``split_gather``: the models read it from the mesh
    they are given, and :meth:`using_ring` gives a view with it set.
    """

    axis = PEER_AXIS

    def __init__(self, n_peers: int, device="cuda", group=None,
                 ring: bool = False):
        if not dist.is_initialized():
            raise RuntimeError("PeerMesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        if n_peers % self.world != 0:
            raise ValueError(
                f"n_peers ({n_peers}) must divide by the world size "
                f"({self.world})")
        self.n = int(n_peers)
        self.block = self.n // self.world
        self.row0 = self.rank * self.block
        self.device = _rank_device(device)
        self.ring = bool(ring)
        self.backend = str(dist.get_backend(self.group))
        # Point-to-point blocks of a gloo group on CUDA travel through host
        # buffers; shared by every view of this mesh.
        self.staged: Dict[str, int] = {"bytes": 0, "ops": 0}
        self._global = [dist.get_global_rank(self.group, r)
                        if self.group is not dist.group.WORLD else r
                        for r in range(self.world)]

    def using_ring(self, ring: bool) -> "PeerMesh":
        """A view of this mesh (same group and counters) whose
        :meth:`gather` takes the ring when ``ring`` is set."""
        view = copy.copy(self)
        view.ring = bool(ring)
        return view

    @property
    def _stage(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- blocks ---------------------------------------------------------------

    def local(self, x, dim: int = 0):
        """This rank's block of a whole per-peer array (rows ``row0 ...
        row0 + B`` along ``dim``)."""
        if x is None:
            return None
        if x.shape[dim] != self.n:
            raise ValueError(
                f"peer dim {dim} of shape {tuple(x.shape)} is not N={self.n}")
        rows = slice(self.row0, self.row0 + self.block)
        idx = (slice(None),) * dim + (rows,)
        return x[idx]

    # -- collectives --------------------------------------------------------

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather of a block along dim 0 -> the whole table, rank 0's
        block first."""
        w = _to_wire(x)
        if self.world == 1:
            out = torch.empty_like(w)
            if self.backend == "nccl":
                dist.all_gather_into_tensor(out, w, group=self.group)
            else:
                dist.all_gather([out], w, group=self.group)
            return _from_wire(out, x.dtype)
        if self.backend == "nccl":
            out = torch.empty((self.world * w.shape[0],) + tuple(w.shape[1:]),
                              dtype=w.dtype, device=w.device)
            dist.all_gather_into_tensor(out, w, group=self.group)
        else:
            parts = [torch.empty_like(w) for _ in range(self.world)]
            dist.all_gather(parts, w, group=self.group)
            out = torch.cat(parts, dim=0)
        return _from_wire(out, x.dtype)

    def gather(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``whole_table[clip(idx)]`` for this rank's block ``table``
        (``world * table.shape[0]`` rows in all) at global row ids ``idx``:
        the split-gather ring when :attr:`ring` is set, else an all-gather
        and a local index.  Bit for bit either way."""
        if self.ring:
            return ring_gather_rows(table, idx, self)
        whole = self.all_gather_rows(table)
        return take_rows(whole, torch.clamp(idx, 0, whole.shape[0] - 1))

    def gather_elems(self, plane: torch.Tensor, jidx: torch.Tensor,
                     ridx: torch.Tensor) -> torch.Tensor:
        """``whole_plane[jidx, ridx]`` of a [B, K] block plane (the flat
        block ``B * K`` elements is a contiguous run of the whole flat
        plane, so this is :meth:`gather` of the flattened rows)."""
        k = plane.shape[1]
        flat = jidx.long() * k + ridx.long()
        return self.gather(plane.reshape(-1), flat)

    def shift(self, buf: torch.Tensor):
        """Post this rank's ``buf`` to rank - 1 and a receive of rank + 1's
        (the ring's step) -> a callable that waits and returns the
        received block."""
        if self.world == 1:
            return lambda: buf
        send_to = self._global[(self.rank - 1) % self.world]
        recv_from = self._global[(self.rank + 1) % self.world]
        w = _to_wire(buf)
        if self._stage:
            w = w.cpu()
            self.staged["bytes"] += 2 * w.numel() * w.element_size()
            self.staged["ops"] += 1
        recv = torch.empty_like(w)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, send_to, self.group),
            dist.P2POp(dist.irecv, recv, recv_from, self.group),
        ])

        def done() -> torch.Tensor:
            for r in reqs:
                r.wait()
            out = recv.to(buf.device) if self._stage else recv
            return _from_wire(out, buf.dtype)

        return done

    def _reduce(self, x, op) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        if t.dtype.is_floating_point:
            raise TypeError(
                "PeerMesh reduces integers only: a float sum over ranks adds "
                "in another order than the reference")
        dt = t.dtype
        w = t.to(torch.int64) if dt in (torch.bool, torch.uint8, torch.int8,
                                        torch.int16, torch.uint16) else t
        w = w.clone().contiguous()
        dist.all_reduce(w, op=op, group=self.group)
        return w.to(dt) if w.dtype != dt else w

    def sum(self, x) -> torch.Tensor:
        """Integer all-reduce SUM (elementwise)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def min(self, x) -> torch.Tensor:
        """Integer all-reduce MIN (elementwise)."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def max(self, x) -> torch.Tensor:
        """Integer all-reduce MAX (elementwise)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """bool: ``x.any()`` over every rank's ``x``."""
        return self.max(x.any().to(torch.int32)) > 0

    def gather_canonical(self, state, peer_dims: Dict[str, int],
                         inv: Optional[np.ndarray] = None,
                         perm: Optional[np.ndarray] = None,
                         id_fields: Sequence[str] = (),
                         ) -> Dict[str, np.ndarray]:
        """The whole state as host numpy, in canonical order: every leaf of
        a peer-dim field (``peer_dims[name]`` its peer axis) all-gathered
        and, under a placement, taken at ``inv`` along that axis; leaves of
        ``id_fields`` hold physical peer ids (``-1`` invalid), which map
        back through ``perm``.  Replicated leaves come as they are.  Keys
        are dotted leaf names (``counters.time_in_mesh``)."""
        out: Dict[str, np.ndarray] = {}
        for name, value in _leaves(state):
            field = name.split(".")[0]
            if field in peer_dims:
                d = peer_dims[field]
                x = value.movedim(d, 0) if d else value
                whole = self.all_gather_rows(x.contiguous()).cpu()
                a = (whole.movedim(0, d) if d else whole).numpy()
                if inv is not None:
                    a = np.take(a, inv, axis=d)
                    if field in id_fields:
                        a = canonical_ids(a, perm)
                out[name] = a
            else:
                out[name] = (value.cpu().numpy() if isinstance(
                    value, torch.Tensor) else np.asarray(value))
        return out


def _leaves(x, pre=""):
    for name in type(x)._fields:
        v = getattr(x, name)
        if hasattr(v, "_fields"):
            yield from _leaves(v, pre + name + ".")
        else:
            yield pre + name, v


def canonical_ids(plane: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """A plane of physical peer ids (its storage form: narrow and
    wrap-encoded, or signed) mapped to canonical ids through ``perm``,
    ``-1`` kept, in the same storage form."""
    n = len(perm)
    ids = np.asarray(decode_index_plane(plane), np.int64)
    canon = np.where(ids >= 0, np.asarray(perm)[np.clip(ids, 0, n - 1)], -1)
    return encode_index_plane(canon, n, dtype=plane.dtype)


def _rank_device(device) -> torch.device:
    """``torch.device`` of ``device``; ``"cuda"`` without an index is the
    current card; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_peers: int, device="cuda", group=None) -> PeerMesh:
    """The :class:`PeerMesh` of an initialised group (the default group
    unless ``group``) over ``n_peers`` peers on ``device`` (the current
    card by default; ``device="cpu"`` for a CPU group)."""
    return PeerMesh(n_peers, device=device, group=group)


# -- the classification: which leaves shard, on which axis --------------------


def state_blocks(state: Any, n_peers: int, world: int,
                 replicated: frozenset = frozenset(),
                 peer_dim: Optional[dict] = None) -> Dict[str, Optional[int]]:
    """Per field of a NamedTuple state: its peer axis, or None when it
    replicates (the reference's ``state_shardings`` rules, which this
    validates the same way): the classification is exhaustive and by
    NAME, never by shape (``msg_window == n_peers`` must not shard the
    message metadata); an unclassified field, an unknown name or a field
    in both sets is an error; every peer-dim leaf has the peer dimension
    ``n_peers`` there, divisible by ``world``."""
    if not hasattr(state, "_fields"):
        raise ValueError("state_blocks classifies NamedTuple states only")
    if n_peers % world != 0:
        raise ValueError(
            f"peer dim {n_peers} not divisible by mesh axis size {world}")
    peer_dim = dict(peer_dim or {})
    fields = set(state._fields)
    unknown = (set(replicated) | set(peer_dim)) - fields
    if unknown:
        raise ValueError(
            f"classified names not in {type(state).__name__}: "
            f"{sorted(unknown)}")
    both = set(replicated) & set(peer_dim)
    if both:
        raise ValueError(
            f"fields classified both replicated and peer-dim: {sorted(both)}")
    unclassified = fields - set(replicated) - set(peer_dim)
    if unclassified:
        raise ValueError(
            f"{type(state).__name__} fields without a sharding rule: "
            f"{sorted(unclassified)}; name every field in `replicated=` or "
            f"`peer_dim=`")
    for name, d in peer_dim.items():
        for leaf_name, leaf in _leaves_of(getattr(state, name), name):
            ndim = getattr(leaf, "ndim", 0)
            if ndim <= d:
                raise ValueError(
                    f"leaf {leaf_name} of shape {tuple(leaf.shape)} has no "
                    f"dim {d} to shard")
            if leaf.shape[d] != n_peers:
                raise ValueError(
                    f"peer-dim leaf {leaf_name} has shape "
                    f"{tuple(leaf.shape)}, expected dim {d} == {n_peers}")
    return {name: peer_dim.get(name) for name in state._fields}


def _leaves_of(v, name):
    if hasattr(v, "_fields"):
        for sub in v._fields:
            yield from _leaves_of(getattr(v, sub), f"{name}.{sub}")
    else:
        yield name, v


def shard_state(state: Any, mesh: PeerMesh,
                replicated: frozenset = frozenset(),
                peer_dim: Optional[dict] = None, device=None):
    """A rank's block of a whole state: every peer-dim leaf cut to the
    rank's rows along its peer axis, replicated leaves kept; tensors moved
    to ``device`` (the mesh's by default)."""
    dims = state_blocks(state, mesh.n, mesh.world, replicated, peer_dim)
    dev = mesh.device if device is None else torch.device(device)

    def cut(v, d):
        if hasattr(v, "_fields"):
            return type(v)(*(cut(x, d) for x in v))
        if not isinstance(v, torch.Tensor):
            return v
        if d is not None:
            v = mesh.local(v, d).contiguous()
        return v.to(dev)

    return type(state)(**{name: cut(getattr(state, name), dims[name])
                          for name in state._fields})


# -- spawning a group ---------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, backend, device, port, timeout, fn, args, queue):
    try:
        torch.set_num_threads(1)
        dev = torch.device(device.format(rank=rank))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        import datetime

        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout),
            **({"device_id": dev} if backend == "nccl" else {}))
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, backend: str = "nccl",
              device="cuda:{rank}", timeout: float = 300.0,
              args: Sequence = ()) -> list:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks of a fresh
    ``backend`` group (``tcp://127.0.0.1`` on a free port) -> the ranks'
    return values, by rank.  ``device`` may name the rank; the default is
    one card a rank over NCCL (``"cuda:{rank}"``), and a CPU group asks
    for ``backend="gloo", device="cpu"``.

    ``fn`` and ``args`` must pickle (a module-level function; numpy
    arguments).  Each rank pins one intra-op thread.  Raises
    ``RuntimeError`` with the rank's traceback when a rank raises, and
    ``TimeoutError`` (after killing every rank) when the group has not
    answered within ``timeout`` seconds."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, world, backend, str(device), port, timeout, fn, tuple(args),
              q),
        daemon=True) for r in range(world)]
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world - len(results)} of {world} ranks did "
                    f"not answer within {timeout} s")
            try:
                rank, ok, out = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank process exited with code "
                        f"{dead[0].exitcode} before answering")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} raised:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(world)]
