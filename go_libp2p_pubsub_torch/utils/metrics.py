"""Metrics over model state: reductions on the device, digests on the host.

Port of the JAX package's ``utils/metrics.py``: ``tree_metrics`` and
``gossip_metrics`` are reductions over a ``TreeState`` / ``GossipState``
that stay on the device until the caller reads them; ``flight_summary`` brings a rollout's flight record
to the host once.  ``snapshot``, ``quantiles`` and the host-side
``MetricsRegistry`` with its Prometheus rendering are copies of the
reference's (``snapshot`` reads tensors instead of jax arrays), which the
streaming engine and its ingest ring report into.
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import bitpack
from ..ops.histogram import hist_quantile


def tree_metrics(st) -> Dict[str, torch.Tensor]:
    """Reductions over a ``TreeState`` (the v0-parity engine): delivery
    totals (``client.go:124-127``), membership (``subtree.go:152``) and the
    orphan backlog, as int32 device scalars."""
    i32 = torch.int32
    alive = st.alive
    joined = st.joined & alive
    orphaned = alive & ~st.joined & (st.join_target >= 0)
    return {
        "peers_alive": alive.sum(dtype=i32),
        "peers_joined": joined.sum(dtype=i32),
        "peers_orphaned": orphaned.sum(dtype=i32),
        "msgs_delivered_total": st.out_len.sum(dtype=i32),
        "msgs_undrained": (st.out_len - st.out_drained).sum(dtype=i32),
        "queue_backlog": st.q_len.sum(dtype=i32),
        "max_queue_depth": st.q_len.max(),
        "tree_depth_proxy": st.subtree_size.max(),
        "step": st.step_num,
    }


def gossip_metrics(st) -> Dict[str, torch.Tensor]:
    """Reductions over a ``GossipState``: mesh health, delivery, scores."""
    alive = st.alive
    alive_n = torch.clamp(alive.sum(dtype=torch.int32), min=1)
    mesh_deg = (st.mesh & st.nbr_valid).sum(dim=1, dtype=torch.int32)
    in_window = st.msg_used & st.msg_valid
    have = bitpack.unpack(st.have_w, st.msg_valid.shape[0])
    delivered = (have & alive[:, None]).sum(dim=0, dtype=torch.int32)
    frac = torch.where(in_window, delivered / alive_n, torch.nan)
    scores_live = torch.where(st.nbr_valid, st.scores, torch.nan)
    return {
        "peers_alive": alive.sum(dtype=torch.int32),
        "mesh_degree_mean": torch.where(alive, mesh_deg, 0).sum(
            dtype=torch.int32) / alive_n,
        "mesh_degree_max": mesh_deg.max(),
        "msgs_in_window": in_window.sum(dtype=torch.int32),
        "delivery_frac_mean": torch.nanmean(frac),
        "deliveries_total": (
            have & alive[:, None] & in_window[None, :]).sum(dtype=torch.int32),
        "score_mean": torch.nanmean(scores_live),
        "score_min": torch.where(torch.isnan(scores_live), torch.inf,
                                 scores_live).min(),
        "gossip_pending": bitpack.popcount(st.gossip_pend_w).sum(
            dtype=torch.int32),
        "step": torch.tensor(st.step, dtype=torch.int32),
    }


def flight_summary(record: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Host-side digest of a ``rollout(record=True)`` flight record: every
    per-round scalar channel as a list of floats, and the final cumulative
    latency histogram with its p50/p99."""
    host = {name: t.detach().cpu().numpy() for name, t in record.items()}
    out: Dict[str, Any] = {"series": {}}
    for name, arr in sorted(host.items()):
        a = np.asarray(arr)
        if a.ndim == 1:
            out["series"][name] = [round(float(v), 6) for v in a]
    if "lat_hist" in host:
        final = np.asarray(host["lat_hist"])[-1]
        out["lat_hist"] = [int(v) for v in final]
        counts = torch.from_numpy(final.astype(np.int32))
        out["lat_p50"] = float(hist_quantile(counts, 0.5))
        out["lat_p99"] = float(hist_quantile(counts, 0.99))
    return out


def snapshot(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A metrics dict of device scalars -> host floats."""
    return {k: float(v) for k, v in metrics.items()}


def quantiles(samples, qs: Tuple[float, ...] = (0.5, 0.99)) -> Dict[str, float]:
    """Host-side exact quantiles over raw samples, keyed ``p50``-style.

    The streaming engine's ingest→delivery latencies are a host list, not a
    device histogram, so unlike ``flight_summary`` no bucket interpolation
    is involved.  Empty input yields NaNs (nothing completed yet).
    """
    import numpy as _np

    keys = [f"p{round(q * 100, 6):g}" for q in qs]
    if len(samples) == 0:
        return {k: float("nan") for k in keys}
    vals = _np.percentile(_np.asarray(samples, dtype=_np.float64),
                          [q * 100.0 for q in qs])
    return {k: float(v) for k, v in zip(keys, vals)}


# ---------------------------------------------------------------------------
# host-side registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Named scalar time series with counter/gauge semantics.

    The host plane (``net/live.py``) and benchmark harnesses record here;
    ``export()`` emits JSON lines, the build's analog of a metrics endpoint.
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._counters: Dict[str, float] = {}
        self._series: Dict[str, List[Tuple[float, float]]] = {}
        # Decorated key -> (base name, sorted (label, value) items); plain
        # keys have no entry and render label-less.
        self._meta: Dict[str, Tuple[str, Tuple[Tuple[str, str], ...]]] = {}
        self._help: Dict[str, str] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = self._key(name, labels)
        self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        key = self._key(name, labels)
        self._series.setdefault(key, []).append((self._clock(), float(value)))

    def describe(self, name: str, help_text: str) -> None:
        """Attach a HELP string to a metric's BASE name (pre-sanitization);
        undescribed metrics render their original dotted name as HELP."""
        self._help[name] = help_text

    def _key(self, name: str, labels: Optional[Dict[str, str]]) -> str:
        if not labels:
            return name
        items = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = name + "{" + ",".join(f"{k}={v}" for k, v in items) + "}"
        self._meta[key] = (name, items)
        return key

    def observe_state(self, prefix: str,
                      metrics: Dict[str, torch.Tensor]) -> None:
        """Record a device metrics dict as gauges under ``prefix.*``."""
        for k, v in snapshot(metrics).items():
            self.gauge(f"{prefix}.{k}", v)

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    def counter(self, name: str, default: float = 0.0) -> float:
        """One counter's current value (``default`` if never incremented) —
        the read side the retry/breaker tests and the live scenario runner
        use to assert on transition counts."""
        return self._counters.get(name, default)

    def latest(self, name: str) -> Optional[float]:
        s = self._series.get(name)
        return s[-1][1] if s else None

    def series_max(self, name: str) -> Optional[float]:
        """Max value ever recorded on a gauge series (peak queue depth and
        friends), or None if the series was never written."""
        s = self._series.get(name)
        return max(v for _, v in s) if s else None

    def export(self) -> str:
        """All counters + latest gauges as one JSON object string."""
        out: Dict[str, Any] = {f"counter.{k}": v for k, v in self._counters.items()}
        for name, series in self._series.items():
            out[f"gauge.{name}"] = series[-1][1]
        return json.dumps(out, sort_keys=True)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4) of all counters
        and the latest sample of every gauge series — the body the live and
        serving planes' ``/metrics`` endpoints serve.  Audited against the
        exposition format (r18): per-metric ``# HELP`` + ``# TYPE`` lines
        (HELP defaults to the original dotted name, with backslash/newline
        escaping), names sanitized to the metric grammar (dots and other
        illegal runes become ``_``), counters suffixed ``_total``, and
        labeled series rendered with escaped label values under ONE shared
        HELP/TYPE header per base metric."""
        lines: List[str] = []
        self._render_family(lines, "counter", self._counters,
                            lambda v: v)
        self._render_family(lines, "gauge", self._series,
                            lambda s: s[-1][1])
        return "\n".join(lines) + "\n"

    def _render_family(self, lines: List[str], kind: str, store: Dict,
                       value_of) -> None:
        groups: Dict[str, List[Tuple[Tuple[Tuple[str, str], ...], Any]]] = {}
        for key in store:
            base, labels = self._meta.get(key, (key, ()))
            groups.setdefault(base, []).append((labels, value_of(store[key])))
        for base in sorted(groups):
            pn = _prometheus_name(base) + ("_total" if kind == "counter"
                                           else "")
            help_text = _prometheus_help(self._help.get(base, base))
            lines.append(f"# HELP {pn} {help_text}")
            lines.append(f"# TYPE {pn} {kind}")
            for labels, value in sorted(groups[base], key=lambda p: p[0]):
                label_str = ""
                if labels:
                    label_str = "{" + ",".join(
                        f'{_prometheus_label_name(k)}='
                        f'"{_prometheus_label_value(v)}"'
                        for k, v in labels
                    ) + "}"
                lines.append(f"{pn}{label_str} {_prometheus_value(value)}")


def _prometheus_name(name: str) -> str:
    """Sanitize to the metric-name grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not name or not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return name


def _prometheus_label_name(name: str) -> str:
    """Label-name grammar is the metric grammar WITHOUT colons:
    ``[a-zA-Z_][a-zA-Z0-9_]*``."""
    name = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if not name or not re.match(r"[a-zA-Z_]", name[0]):
        name = "_" + name
    return name


def _prometheus_label_value(v: str) -> str:
    """Escape a label value per the exposition format: backslash, double
    quote, and line feed."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prometheus_help(text: str) -> str:
    """HELP text escaping: backslash and line feed only (quotes are legal
    in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _prometheus_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f.is_integer() else repr(f)
