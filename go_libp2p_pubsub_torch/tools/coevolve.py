"""Adversarial co-evolution: the fuzzer and the defense harden each other.

r13's ``scenario_fuzz`` finds SLO-red attack campaigns against a FIXED
defense; r14's ``--search defense`` samples score-parameter space against
a FIXED battery.  This tool closes the loop (ROADMAP item 5): an
alternating attack-search / defense-search iteration in which

1. the ATTACK phase hunts red campaigns against the *current* defense —
   drawing from the fuzzer's sampler, optionally composed with the
   realism textures of ``scenario/realism.py`` (heavy-tailed topologies,
   geographic latency, diurnal churn) — and every red found is minimized
   by the fuzzer's shrinker and archived as a replayable artifact;
2. the DEFENSE phase proposes candidates by coordinate descent around the
   current config (enable a missing penalty axis, scale a weight, nudge a
   threshold) plus a few exploration draws from the fuzzer's defense
   sampler.  Every candidate must pass the formal invariant gate
   (``scenario.defense.check_invariants`` — the machine-checkable
   constraints from tests/test_scoring_invariants.py: P4/P7 penalty
   monotonicity, P6 sign, bounded mesh capture, honest-score floor)
   BEFORE it may be graded; rejections are recorded, not crashed on.
   Surviving candidates are scored by how many archived reds plus quick-
   battery campaigns stay red under them, and the best (strictly fewer
   reds than the incumbent) becomes the next iteration's defense.

After the loop, the PROMOTION GATE grades the surviving config against
the FULL attack canon plus a fresh fuzz battery (indices disjoint from
the hunt's) and compares it to the standing config; the config is
promoted only if it dominates (no worse on every axis, strictly better on
at least one).  The whole decision history — every red digest, every gate
rejection with its violated invariant, every candidate's objective, the
final margin table — is written as a JSON audit artifact, and the
promoted config is published to
``go_libp2p_pubsub_torch/scenario/promoted_defense.json`` (the shipped
default: ``scenario.PROMOTED_DEFENSE`` loads it).

The run is a pure function of ``--seed``: attack draws reuse the
fuzzer's substream (tag 5), realism composition draws come from the
coevolve substream (tag 8), exploration defense draws use the fuzzer's
defense substream (tag 6) at indices offset per iteration, and the fresh
gate battery uses fuzz indices offset by 10_000.  No wall clock is ever
read, so two same-seed runs emit byte-identical audits.

Usage (``C = python -m go_libp2p_pubsub_torch.tools.coevolve``)::

    C --budget 3 --seed 0
    C --budget 2 --seed 0 --attack-budget 2 \
        --defense-probes 2 --no-shrink --dry-run --json   # tier-1 smoke
    C --budget 3 --seed 0 --device cpu                    # on the CPU

Exit code 0 when the loop completes (whether or not promotion happened);
1 on usage errors; 2 without a card for ``--device cuda``.  Every
campaign and the deep invariant gate's rollout run on ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from ..scenario import realism
from ..scenario.defense import (
    PROMOTED_PATH, STANDING_DEFENSE, check_invariants, defense_digest,
)
from ..scenario.spec import ScenarioSpec
from . import device_error
from . import scenario_fuzz as fuzz

# Coevolve substream tag: disjoint from the compiler's (1-4), the
# fuzzer's (5-6), and realism's (7) substreams.
_TAG_COEVOLVE = 8

# Fresh-battery index offset: the promotion gate's fuzz draws must be
# DISJOINT from the loop's hunt indices so "fresh" means fresh.
_GATE_INDEX_OFFSET = 10_000


def sample_attack(
    seed: int, index: int, defense: Dict[str, float], use_realism: bool
) -> ScenarioSpec:
    """One attack-phase draw: a fuzzed campaign, optionally composed with
    realism textures (pure in (seed, index))."""
    spec = fuzz.sample_spec(seed, index, defense)
    if not use_realism:
        return spec
    rng = np.random.default_rng([seed, _TAG_COEVOLVE, index])
    if rng.random() < 0.4:
        topology = {
            "kind": "heavy_tailed",
            "alpha": float(rng.choice([2.0, 2.5])),
        }
        spec = realism.apply_realism(
            spec, seed=int(rng.integers(0, 2**31 - 1)),
            topology=topology,
            geo=bool(rng.random() < 0.5),
            diurnal=bool(rng.random() < 0.5),
        )
    return spec


def _with_defense(spec: ScenarioSpec, defense: Dict[str, float]) -> ScenarioSpec:
    return dataclasses.replace(
        spec, model=dict(spec.model, score_params=dict(defense))
    )


def red_under(spec: ScenarioSpec, defense: Dict[str, float],
              device="cuda") -> bool:
    status, _, _ = fuzz._grade(_with_defense(spec, defense), device=device)
    return status == "red"


def propose_candidates(
    seed: int, iteration: int, current: Dict[str, float], n_probes: int
) -> List[Dict[str, float]]:
    """Deterministic coordinate-descent probe schedule around ``current``.

    The first probe is always the P4 sign flip — an invariant-violating
    candidate by construction, so every run exercises (and records) at
    least one gate rejection; it can never be graded, let alone win.
    Then: enable each missing penalty axis, rescale each enabled weight,
    nudge the colocation threshold, and top up with exploration draws
    from the fuzzer's defense sampler at per-iteration index offsets.
    """
    probes: List[Dict[str, float]] = []
    # 1. Adversarial self-check: positive P4 weight (gate must reject).
    probes.append(dict(
        current,
        invalid_message_deliveries_weight=abs(
            current.get("invalid_message_deliveries_weight", -1.0)
        ),
    ))
    # 2. Enable missing axes at their hand-tuned magnitudes.
    if "mesh_message_deliveries_weight" not in current:
        probes.append(dict(
            current,
            mesh_message_deliveries_weight=-1.0,
            mesh_message_deliveries_threshold=1.5,
            mesh_message_deliveries_activation_s=3.0,
        ))
    if "behaviour_penalty_weight" not in current:
        probes.append(dict(current, behaviour_penalty_weight=-1.0))
    if "ip_colocation_factor_weight" not in current:
        probes.append(dict(
            current,
            ip_colocation_factor_weight=-1.0,
            ip_colocation_factor_threshold=1.0,
        ))
    # 3. Rescale each enabled weight (the coordinate-descent step).
    for key in sorted(current):
        if key.endswith("_weight") and current[key] != 0.0:
            for scale in (2.0, 0.5):
                probes.append(dict(current, **{key: current[key] * scale}))
    if "ip_colocation_factor_threshold" in current:
        probes.append(dict(
            current,
            ip_colocation_factor_threshold=(
                current["ip_colocation_factor_threshold"] + 1.0
            ),
        ))
    # 4. Exploration: fuzzer defense draws at per-iteration offsets.
    for j in range(2):
        probes.append(
            fuzz.sample_defense(seed, 1000 + 100 * iteration + j)
        )
    # Dedup (a rescale can collide with an enable), cap at n_probes while
    # always keeping the sign-flip probe.
    seen, out = set(), []
    for p in probes:
        d = defense_digest(p)
        if d in seen:
            continue
        seen.add(d)
        out.append(p)
    return out[:n_probes]


def objective(
    defense: Dict[str, float],
    archive: List[ScenarioSpec],
    quick_battery: bool,
    device="cuda",
) -> Dict[str, Any]:
    """Count how many known attacks stay red under ``defense``: the
    archived minimized reds plus (optionally) the fuzzer's quick canon
    battery.  Lower is better."""
    archive_reds = sum(red_under(s, defense, device) for s in archive)
    battery_reds = 0
    battery = []
    if quick_battery:
        worst, results = fuzz.grade_defense(defense, device=device)
        battery = [
            {"name": n, "status": st, "failed": failed}
            for n, st, failed in results
        ]
        battery_reds = sum(
            1 for e in battery if e["status"] != "green"
        )
    return {
        "archive_reds": int(archive_reds),
        "battery_reds": int(battery_reds),
        "total": int(archive_reds + battery_reds),
        "battery": battery,
    }


def gate_report(
    defense: Dict[str, float],
    seed: int,
    fresh_budget: int,
    archive: List[ScenarioSpec],
    full: bool = True,
    limit: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Grade a config for the promotion decision: full canon battery,
    fresh fuzz battery (gate-offset indices), archived reds."""
    battery = fuzz.full_battery() if full else fuzz.DEFENSE_BATTERY
    if limit:
        battery = battery[:limit]
    worst, results = fuzz.grade_defense(defense, battery=battery,
                                        device=device)
    canon_reds = sum(1 for _, st, _ in results if st != "green")
    fresh_reds = 0
    fresh: List[Dict[str, Any]] = []
    for i in range(fresh_budget):
        spec = fuzz.sample_spec(seed, _GATE_INDEX_OFFSET + i, defense)
        status, _, failed = fuzz._grade(spec, device=device)
        fresh.append({
            "index": _GATE_INDEX_OFFSET + i,
            "digest": fuzz._digest(spec),
            "kind": spec.attacks[0].kind,
            "status": status,
        })
        fresh_reds += status == "red"
    return {
        "digest": defense_digest(defense),
        "canon": [
            {"name": n, "status": st, "failed": failed}
            for n, st, failed in results
        ],
        "canon_reds": int(canon_reds),
        "fresh_battery": fresh,
        "fresh_reds": int(fresh_reds),
        "archive_reds": int(
            sum(red_under(s, defense, device) for s in archive)
        ),
    }


def dominates(final: Dict[str, Any], standing: Dict[str, Any]) -> bool:
    """Promotion rule: no worse on every axis, strictly better on one."""
    axes = ("canon_reds", "fresh_reds", "archive_reds")
    no_worse = all(final[a] <= standing[a] for a in axes)
    better = any(final[a] < standing[a] for a in axes)
    return no_worse and better


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--budget", type=int, default=3,
                    help="alternating attack<->defense iterations "
                    "(default 3)")
    ap.add_argument("--seed", type=int, default=0,
                    help="loop seed; the whole run is a pure function of "
                    "it (default 0)")
    ap.add_argument("--attack-budget", type=int, default=10,
                    help="fuzz samples per attack phase (default 10)")
    ap.add_argument("--defense-probes", type=int, default=8,
                    help="defense candidates per defense phase "
                    "(default 8)")
    ap.add_argument("--fresh-budget", type=int, default=10,
                    help="fresh fuzz battery size at the promotion gate "
                    "(default 10)")
    ap.add_argument("--shallow-gate", action="store_true",
                    help="invariant-gate candidates with the ops sweeps "
                    "only (skip the sybil rollout; smoke/test mode)")
    ap.add_argument("--no-realism", action="store_true",
                    help="attack phase samples plain fuzz campaigns only")
    ap.add_argument("--no-shrink", action="store_true",
                    help="archive reds unminimized (smoke/test mode)")
    ap.add_argument("--quick-gate", action="store_true",
                    help="promotion gate uses the quick 3-campaign "
                    "battery instead of the full canon (smoke/test mode)")
    ap.add_argument("--gate-battery", type=int, default=0,
                    help="cap the promotion-gate canon battery at N "
                    "entries (0 = no cap; smoke/test mode)")
    ap.add_argument("--no-quick-battery", action="store_true",
                    help="defense-phase objective counts archived reds "
                    "only (skip the quick canon battery; smoke/test mode)")
    ap.add_argument("--archive-dir", default="tests/golden",
                    help="directory for minimized red replay artifacts "
                    "(default tests/golden)")
    ap.add_argument("--audit", default="tests/golden/coevolve_audit.json",
                    help="audit artifact path "
                    "(default tests/golden/coevolve_audit.json)")
    ap.add_argument("--promote", default=PROMOTED_PATH,
                    help="promoted-config artifact path (default: the "
                    "shipped scenario/promoted_defense.json)")
    ap.add_argument("--dry-run", action="store_true",
                    help="never write the promoted-config artifact "
                    "(audit and archives still written)")
    ap.add_argument("--json", action="store_true",
                    help="emit the audit document to stdout as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the campaigns and the deep gate's rollout "
                    "run (default cuda; cpu runs them on the CPU)")
    args = ap.parse_args(argv)
    if args.budget < 1:
        ap.error("--budget must be >= 1")
    if args.attack_budget < 1 or args.defense_probes < 1:
        ap.error("--attack-budget and --defense-probes must be >= 1")
    err = device_error(args.device)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2

    log = (lambda *a: None) if args.json else print
    current = dict(STANDING_DEFENSE)
    archive: List[ScenarioSpec] = []
    archive_paths: List[str] = []
    iterations: List[Dict[str, Any]] = []
    n_rejections = 0

    for it in range(args.budget):
        # ---- attack phase: hunt reds against the current defense -------
        cur_digest = defense_digest(current)
        log(f"[iter {it}] attack phase vs defense {cur_digest}")
        findings: List[Dict[str, Any]] = []
        for j in range(args.attack_budget):
            index = it * args.attack_budget + j
            spec = sample_attack(
                args.seed, index, current, not args.no_realism
            )
            status, _, failed = fuzz._grade(spec, device=args.device)
            entry: Dict[str, Any] = {
                "index": index,
                "digest": fuzz._digest(spec),
                "kind": spec.attacks[0].kind,
                "realism": "topology" in spec.model,
                "status": status,
                "failed": failed,
                "defense_digest": cur_digest,
            }
            if status == "red":
                red = spec
                if not args.no_shrink:
                    red = fuzz.shrink(spec, lambda m: log("   " + m),
                                      device=args.device)
                red = dataclasses.replace(red, meta=dict(
                    red.meta or {},
                    defense_digest=cur_digest,
                    found_by="coevolve",
                    search_seed=args.seed,
                    iteration=it,
                    sample_index=index,
                ))
                path = os.path.join(
                    args.archive_dir,
                    f"coevolve_red_s{args.seed}_i{index:04d}.json",
                )
                os.makedirs(args.archive_dir, exist_ok=True)
                with open(path, "w") as f:
                    f.write(red.to_json())
                archive.append(red)
                archive_paths.append(path)
                entry["minimized_digest"] = fuzz._digest(red)
                entry["archived"] = path
                log(f"  RED {entry['kind']} -> archived {path}")
            findings.append(entry)

        # ---- defense phase: gated coordinate descent -------------------
        log(f"[iter {it}] defense phase ({len(archive)} archived reds)")
        incumbent = objective(
            current, archive, quick_battery=not args.no_quick_battery,
            device=args.device,
        )
        candidates: List[Dict[str, Any]] = []
        best, best_obj = current, incumbent
        for cand in propose_candidates(
            args.seed, it, current, args.defense_probes
        ):
            ok, violations = check_invariants(
                cand, deep=not args.shallow_gate, device=args.device
            )
            record: Dict[str, Any] = {
                "digest": defense_digest(cand),
                "defense": cand,
                "gate": "pass" if ok else "reject",
                "violations": violations,
            }
            if not ok:
                n_rejections += 1
                log(f"  gate REJECT {record['digest']}: "
                    f"{'; '.join(violations)}")
            else:
                obj = objective(
                    cand, archive,
                    quick_battery=not args.no_quick_battery,
                    device=args.device,
                )
                record["objective"] = {
                    k: obj[k]
                    for k in ("archive_reds", "battery_reds", "total")
                }
                log(f"  graded {record['digest']}: "
                    f"{obj['total']} reds "
                    f"({obj['archive_reds']} archive, "
                    f"{obj['battery_reds']} battery)")
                if obj["total"] < best_obj["total"]:
                    best, best_obj = cand, obj
            candidates.append(record)
        adopted = defense_digest(best) != cur_digest
        if adopted:
            log(f"  adopt {defense_digest(best)} "
                f"({best_obj['total']} reds, was "
                f"{incumbent['total']})")
            current = best
        iterations.append({
            "iteration": it,
            "defense_digest": cur_digest,
            "attack": findings,
            "incumbent_objective": {
                k: incumbent[k]
                for k in ("archive_reds", "battery_reds", "total")
            },
            "candidates": candidates,
            "adopted": defense_digest(current),
        })

    # ---- promotion gate ------------------------------------------------
    log(f"promotion gate: {defense_digest(current)} vs standing "
        f"{defense_digest(STANDING_DEFENSE)}")
    standing_rep = gate_report(
        STANDING_DEFENSE, args.seed, args.fresh_budget, archive,
        full=not args.quick_gate, limit=args.gate_battery,
        device=args.device,
    )
    final_rep = gate_report(
        current, args.seed, args.fresh_budget, archive,
        full=not args.quick_gate, limit=args.gate_battery,
        device=args.device,
    )
    promoted = dominates(final_rep, standing_rep)
    audit = {
        "tool": "coevolve",
        "revision": "r21",
        "seed": args.seed,
        "budget": args.budget,
        "attack_budget": args.attack_budget,
        "defense_probes": args.defense_probes,
        "fresh_budget": args.fresh_budget,
        "deep_gate": not args.shallow_gate,
        "realism": not args.no_realism,
        "standing_digest": defense_digest(STANDING_DEFENSE),
        "iterations": iterations,
        "reds_found": len(archive),
        "red_artifacts": archive_paths,
        "invariant_rejections": n_rejections,
        "promotion": {
            "standing": standing_rep,
            "final": final_rep,
            "promoted": bool(promoted),
        },
        "promoted_defense": dict(current) if promoted else None,
        "promoted_digest": (
            defense_digest(current) if promoted else None
        ),
    }
    os.makedirs(os.path.dirname(args.audit) or ".", exist_ok=True)
    with open(args.audit, "w") as f:
        json.dump(audit, f, indent=2, sort_keys=True)
        f.write("\n")
    if promoted and not args.dry_run:
        doc = {
            "defense": dict(current),
            "digest": defense_digest(current),
            "source": "tools/coevolve.py",
            "seed": args.seed,
            "budget": args.budget,
            "audit": args.audit,
        }
        os.makedirs(os.path.dirname(args.promote) or ".", exist_ok=True)
        with open(args.promote, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        log(f"PROMOTED {defense_digest(current)} -> {args.promote}")
    elif promoted:
        log(f"would promote {defense_digest(current)} (dry run)")
    else:
        log("no promotion: final config does not dominate standing")
    log(f"audit -> {args.audit}  "
        f"({len(archive)} reds archived, {n_rejections} gate rejections)")
    if args.json:
        print(json.dumps(audit, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
