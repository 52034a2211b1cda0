"""Realistic network texture for scenario campaigns (r21).

(The JAX package's ``scenario/realism.py``, copied into the port; the
builders lower onto the port's numpy topology builders, and
``config_key`` is kept though the port compiles nothing.)

The canon's meshes are uniform expanders with uniform link quality and
Poisson-ish churn — nothing like the overlays the Filecoin/ETH2
evaluation measured (arXiv 2007.02754): degree distributions are heavy
tailed (a few supernodes carry a disproportionate share of edges),
latency follows geography (a handful of regions, cheap within, expensive
across), and participation is diurnal (peers leave for hours and come
back).  Attacks interact with all three: a sybil that camps a supernode's
slots, an eclipse staged while the victim's region sleeps.

This module supplies those textures as *declarative* scenario
ingredients, so fuzzed and co-evolved campaigns can draw them without the
spec losing its exact JSON round-trip:

- heavy-tailed topology — ``spec.model["topology"]`` dicts lowered by the
  compiler through :func:`topology_builder` into a GossipSub ``builder``
  closure.  Every closure carries a hashable ``config_key`` so equally
  configured models still share jit-compiled rollouts (the model's
  ``_config_key`` honors it instead of falling back to identity).
- geographic latency — :func:`geo_latency_links` projects a region
  latency matrix onto the sim's per-peer ingress-delay fault surface as
  one :class:`LinkWindow` per non-backbone region.
- diurnal churn — :func:`diurnal_churn` emits alternating night-window
  :class:`ChurnPhase` entries with rejoin (peers come back at dawn).

All randomness is drawn from ``np.random.default_rng([seed, _TAG_REALISM,
index])`` — tag 7, disjoint from the compiler's (1-4) and the fuzzer's
(5-6) substreams, so realism draws never alias either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .spec import ChurnPhase, LinkWindow, ScenarioSpec

__all__ = [
    "TOPOLOGY_KINDS",
    "heavy_tailed_builder",
    "topology_builder",
    "geo_latency_links",
    "diurnal_churn",
    "apply_realism",
]

# Realism substream tag (see module docstring).
_TAG_REALISM = 7


# ---------------------------------------------------------------------------
# heavy-tailed topology
# ---------------------------------------------------------------------------

def heavy_tailed_builder(alpha: float = 2.5):
    """A GossipSub topology builder with a Pareto degree distribution.

    Target degrees are i.i.d. Pareto(``alpha``) draws scaled so their mean
    matches the model's ``conn_degree`` and clamped to [1, k-1] (a slot
    table can't hold more).  Smaller ``alpha`` = heavier tail = stronger
    supernodes; alpha <= 1 has no finite mean and is rejected.  Edges come
    from configuration-model stub pairing (self-loops dropped, duplicate
    edges merged), then the shared ``_assign_slots`` tail lowers the edge
    list to slot form — same invariants as the uniform builders.
    """
    if alpha <= 1.0:
        raise ValueError("heavy-tailed alpha must be > 1 (finite mean)")
    alpha = float(alpha)

    def build(
        rng: np.random.Generator, n: int, k: int, degree: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        from ..models.gossipsub import _assign_slots

        if degree >= k:
            raise ValueError(
                f"degree ({degree}) must be < slot count k ({k})"
            )
        if degree == 0 or n < 4:
            empty = np.full((n, k), -1, np.int64)
            return empty, empty.copy(), empty >= 0, np.zeros((n, k), bool)
        # Pareto Type I (x_m = 1) has mean alpha / (alpha - 1); rescale so
        # the target-degree mean is the requested conn_degree.
        x = rng.pareto(alpha, n) + 1.0
        deg = np.clip(
            np.rint(x * degree * (alpha - 1.0) / alpha).astype(np.int64),
            1, min(k - 1, n - 1),
        )
        # Configuration model: one stub per half-edge, shuffled, paired.
        stubs = np.repeat(np.arange(n, dtype=np.int64), deg)
        rng.shuffle(stubs)
        if len(stubs) % 2:
            stubs = stubs[:-1]
        a, b = stubs[0::2], stubs[1::2]
        keep = a != b  # drop self-loops
        a, b = a[keep], b[keep]
        e = np.unique(
            np.stack([np.minimum(a, b), np.maximum(a, b)], 1), axis=0
        )
        dialer = np.where(
            rng.integers(0, 2, len(e)).astype(bool), e[:, 0], e[:, 1]
        )
        return _assign_slots(e, dialer, n, k)

    build.config_key = ("heavy_tailed", alpha)
    return build


def _keyed(builder, key):
    """Wrap an existing builder function with a declared value identity."""
    def build(rng, n, k, degree):
        return builder(rng, n, k, degree)
    build.config_key = key
    return build


TOPOLOGY_KINDS = ("heavy_tailed", "local", "uniform")


def topology_builder(topo: Dict[str, Any]):
    """Lower a declarative ``spec.model["topology"]`` dict to a builder.

    Kinds: ``{"kind": "heavy_tailed", "alpha": float}`` (Pareto degrees),
    ``{"kind": "local", "spread": int | None}`` (ring locality), and
    ``{"kind": "uniform"}`` (the vectorized uniform builder, pinned
    explicitly).  Every returned closure has a ``config_key``.
    """
    from ..models import gossipsub as gsmod

    if not isinstance(topo, dict) or "kind" not in topo:
        raise ValueError("topology must be a dict with a 'kind' key")
    kind = topo["kind"]
    extras = set(topo) - {"kind", "alpha", "spread"}
    if extras:
        raise ValueError(f"unknown topology keys: {sorted(extras)}")
    if kind == "heavy_tailed":
        return heavy_tailed_builder(alpha=float(topo.get("alpha", 2.5)))
    if kind == "local":
        spread = topo.get("spread")
        spread = None if spread is None else int(spread)
        return _keyed(
            lambda rng, n, k, d: gsmod.build_topology_local(
                rng, n, k, d, spread=spread
            ),
            ("local", spread),
        )
    if kind == "uniform":
        return _keyed(gsmod.build_topology_fast, ("uniform",))
    raise ValueError(
        f"unknown topology kind {kind!r} (expected one of {TOPOLOGY_KINDS})"
    )


# ---------------------------------------------------------------------------
# geographic latency
# ---------------------------------------------------------------------------

def geo_latency_links(
    seed: int,
    n: int,
    n_steps: int,
    n_regions: int = 4,
    max_delay: int = 3,
) -> List[LinkWindow]:
    """Project a region latency matrix onto per-peer ingress delays.

    The sim's link fault surface is a per-peer ingress delay, so a full
    pairwise matrix projects onto it as each region's ring distance to
    the backbone (region 0): region r's members receive gossip
    ``min(dist, max_delay)`` rounds late for the whole run.  Region
    membership is a single categorical draw with a mild size skew (the
    backbone region is the largest, like real deployments).  One
    :class:`LinkWindow` per non-backbone region, explicit ``peers`` lists,
    pure in ``seed``.
    """
    if n_regions < 2:
        raise ValueError("n_regions must be >= 2")
    rng = np.random.default_rng([seed, _TAG_REALISM, 1])
    weights = 1.0 / (1.0 + np.arange(n_regions, dtype=np.float64))
    region = rng.choice(n_regions, size=n, p=weights / weights.sum())
    windows: List[LinkWindow] = []
    for r in range(1, n_regions):
        peers = [int(i) for i in np.flatnonzero(region == r)]
        if not peers:
            continue
        dist = min(r, n_regions - r)  # ring distance to the backbone
        windows.append(LinkWindow(
            start=0, stop=n_steps, delay=int(min(max(dist, 1), max_delay)),
            peers=peers,
        ))
    return windows


# ---------------------------------------------------------------------------
# diurnal churn
# ---------------------------------------------------------------------------

def diurnal_churn(
    seed: int,
    n_steps: int,
    period: int = 24,
    night_frac: float = 0.5,
    kills_per_event: int = 1,
    every: int = 4,
) -> List[ChurnPhase]:
    """Alternating day/night participation as :class:`ChurnPhase` entries.

    Each cycle of ``period`` steps ends with a night window of
    ``night_frac`` of the cycle during which peers leave gracefully every
    ``every`` steps and rejoin a night's length later (dawn).  Windows
    that would spill past the scenario end are clipped; pure in ``seed``
    (the seed currently only jitters each night's phase offset, drawn
    from the realism substream).
    """
    if period < 4:
        raise ValueError("diurnal period must be >= 4")
    if not (0.0 < night_frac < 1.0):
        raise ValueError("night_frac must be in (0, 1)")
    rng = np.random.default_rng([seed, _TAG_REALISM, 2])
    night = max(2, int(round(period * night_frac)))
    phases: List[ChurnPhase] = []
    start = period - night + int(rng.integers(0, max(1, every)))
    while start < n_steps - 2:
        stop = min(start + night, n_steps - 1)
        if stop > start:
            phases.append(ChurnPhase(
                start=start, stop=stop, every=every,
                kills_per_event=kills_per_event, graceful=True,
                rejoin_after=night,
            ))
        start += period
    return phases


# ---------------------------------------------------------------------------
# spec composition
# ---------------------------------------------------------------------------

def apply_realism(
    spec: ScenarioSpec,
    seed: int,
    topology: Optional[Dict[str, Any]] = None,
    geo: bool = False,
    diurnal: bool = False,
) -> ScenarioSpec:
    """Compose realism textures onto an existing (fuzzed) sim spec.

    Only adds what the spec doesn't already carry: geo link windows are
    appended to ``links``, diurnal phases to ``churn``, and the topology
    dict replaces ``model["topology"]``.  Returns a new spec; the input
    is never mutated.  Gossipsub-family only (the compiler rejects
    ``topology`` on other families).
    """
    model = dict(spec.model)
    if topology is not None:
        model["topology"] = dict(topology)
    links = list(spec.links)
    if geo:
        n = int(model.get("n_peers", 64))
        links = links + geo_latency_links(seed, n, spec.n_steps)
    churn = list(spec.churn)
    if diurnal:
        churn = churn + diurnal_churn(seed, spec.n_steps)
    return dataclasses.replace(
        spec, model=model, links=links, churn=churn,
    )
