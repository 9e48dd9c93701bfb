"""Accuracy-reproduction verdicts — the port of ``dwt_tpu.utils.repro``
(BASELINE.json north star: ±0.3%).

The reference validated correctness by the accuracy its ``test()`` printed
(``usps_mnist.py:310-327``, ``resnet50…py:447-464``); this module turns
that into an assertable contract: CLIs take ``--expect_accuracy``/
``--tolerance`` and exit nonzero when the trained model misses the target,
and the sweep compares a whole expectation table (paper Table 3).

Expected values must come from the paper PDF (see ``baselines/``) — they
are intentionally shipped as ``null`` templates, not hardcoded from
memory (SURVEY §6).
"""

from __future__ import annotations

import json
from typing import Dict, Optional


def accuracy_verdict(
    actual: float, expected: float, tolerance: float
) -> dict:
    """One repro check: |actual − expected| ≤ tolerance."""
    delta = actual - expected
    return {
        "expected": float(expected),
        "actual": float(actual),
        "delta": round(float(delta), 4),
        "tolerance": float(tolerance),
        "ok": abs(delta) <= tolerance,
    }


def check_cli_accuracy(
    accuracy: float,
    expect_accuracy: Optional[float],
    tolerance: float,
    logger=None,
) -> bool:
    """CLI plumbing: no-op (True) when no expectation was given; otherwise
    log/print the verdict and return whether it passed."""
    if expect_accuracy is None:
        return True
    verdict = accuracy_verdict(accuracy, expect_accuracy, tolerance)
    if logger is not None:
        logger.log("accuracy_check", 0, **verdict)
    else:  # pragma: no cover - all CLIs pass a logger
        print(f"[accuracy_check] {verdict}")
    return verdict["ok"]


def load_expect_table(path: str) -> Dict[str, Optional[float]]:
    """Load a ``{"Source->Target": acc_or_null}`` expectation table.

    ``null`` entries are allowed (template not yet filled from the paper
    PDF) and are skipped by :func:`sweep_verdicts`.
    """
    with open(path) as f:
        table = json.load(f)
    if not isinstance(table, dict):
        raise ValueError(f"{path}: expectation table must be a JSON object")
    out: Dict[str, Optional[float]] = {}
    for key, value in table.items():
        if key.startswith("_"):  # comment/metadata keys
            continue
        if value is not None and (
            isinstance(value, bool) or not isinstance(value, (int, float))
        ):
            raise ValueError(
                f"{path}: {key!r} must be a number or null, got {value!r}"
            )
        out[key] = None if value is None else float(value)
    return out


def sweep_verdicts(
    results: Dict[str, float],
    expected: Dict[str, Optional[float]],
    tolerance: float,
) -> dict:
    """Verdict table for a sweep: per-pair checks plus the mean.

    Pairs with a ``null`` expectation (or absent from ``expected``) are
    reported as ``skipped``.  Non-null expectations that match NO result
    (typo'd key, subset sweep) are listed under ``unmatched`` and force
    ``all_ok`` to False — a silently dropped expectation must never read
    as "Table 3 reproduced".
    """
    pairs = {}
    checked_ok = []
    for pair, acc in results.items():
        exp = expected.get(pair)
        if exp is None:
            pairs[pair] = {"actual": float(acc), "skipped": True}
            continue
        verdict = accuracy_verdict(acc, exp, tolerance)
        pairs[pair] = verdict
        checked_ok.append(verdict["ok"])
    unmatched = sorted(
        k for k, v in expected.items() if v is not None and k not in results
    )
    mean_actual = sum(results.values()) / max(len(results), 1)
    mean_expected_vals = [v for v in expected.values() if v is not None]
    all_ok = all(checked_ok) if checked_ok else None
    if unmatched:
        all_ok = False
    summary = {
        "pairs": pairs,
        "checked": len(checked_ok),
        "skipped": len(results) - len(checked_ok),
        "unmatched": unmatched,
        "all_ok": all_ok,
        "mean_actual": round(mean_actual, 4),
    }
    if mean_expected_vals and len(mean_expected_vals) == len(expected):
        summary["mean_expected"] = round(
            sum(mean_expected_vals) / len(mean_expected_vals), 4
        )
    return summary
