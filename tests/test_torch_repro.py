"""The port's repro verdicts (``dwt_tpu_torch.utils.repro``) against the JAX package's.

``accuracy_verdict``, ``check_cli_accuracy``, ``load_expect_table`` and
``sweep_verdicts`` take the same inputs in both packages — a grid of
accuracies around each expectation that includes the band's edges, the
shipped ``baselines/`` templates, and malformed tables — and must give
equal verdicts, records and refusals.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

from dwt_tpu.utils import repro as jax_repro
from dwt_tpu_torch.utils import repro

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = sorted(glob.glob(os.path.join(REPO, "baselines", "*.json")))


def _grid():
    """Actual accuracies around expectations, on and just off the band's
    edges, from a seed."""
    rng = np.random.default_rng(15)
    cases = []
    for expected in (0.0, 50.0, 61.5, 96.8, 100.0):
        for tol in (0.0, 0.3, 1.0):
            for off in (0.0, tol, -tol, tol + 1e-9, -tol - 1e-9, tol / 2, 2 * tol + 0.1):
                cases.append((expected + off, expected, tol))
    for a, e in rng.uniform(0, 100, size=(20, 2)):
        cases.append((float(a), float(e), 0.3))
    return cases


class _Log:
    def __init__(self):
        self.records = []

    def log(self, kind, step, **values):
        self.records.append((kind, step, values))


@pytest.mark.parametrize("actual,expected,tol", _grid())
def test_accuracy_verdict_matches_jax(actual, expected, tol):
    assert repro.accuracy_verdict(actual, expected, tol) == \
        jax_repro.accuracy_verdict(actual, expected, tol)


def test_check_cli_accuracy_matches_jax():
    ours, ref = _Log(), _Log()
    for actual, expected, tol in _grid() + [(12.3, None, 0.3)]:
        assert repro.check_cli_accuracy(actual, expected, tol, ours) == \
            jax_repro.check_cli_accuracy(actual, expected, tol, ref)
    assert ours.records == ref.records
    assert {k for k, _, _ in ours.records} == {"accuracy_check"}
    assert repro.check_cli_accuracy(1.0, None, 0.3) is True


@pytest.mark.parametrize("path", TEMPLATES, ids=os.path.basename)
def test_shipped_templates_load_and_judge_as_jax(path):
    ours, ref = repro.load_expect_table(path), jax_repro.load_expect_table(path)
    assert ours == ref and ours
    # The templates ship as null: every pair is skipped, none unmatched.
    results = {pair: 50.0 + i for i, pair in enumerate(sorted(ours))}
    assert repro.sweep_verdicts(results, ours, 0.3) == \
        jax_repro.sweep_verdicts(results, ref, 0.3)


TABLES = [
    {"A->B": 50.0, "B->C": None, "_comment": "metadata"},
    {"A->B": 50.0, "B->C": 61.2, "C->D": 70.0},
    {"A->B": True},
    {"A->B": "fifty"},
    [50.0],
]
RESULTS = [
    {"A->B": 50.2, "B->C": 61.0, "X->Y": 3.0},
    {"A->B": 49.0},
    {},
]


@pytest.mark.parametrize("table", TABLES, ids=lambda t: json.dumps(t))
def test_load_expect_table_matches_jax(tmp_path, table):
    path = tmp_path / "table.json"
    path.write_text(json.dumps(table))

    def outcome(mod):
        try:
            return "loaded", mod.load_expect_table(str(path))
        except ValueError as e:
            return "refused", str(e)

    assert outcome(repro) == outcome(jax_repro)


@pytest.mark.parametrize("results", RESULTS, ids=lambda r: json.dumps(r))
@pytest.mark.parametrize("expected", [
    {"A->B": 50.0, "B->C": None},
    {"A->B": 50.0, "B->C": 61.2, "C->D": 70.0},
    {},
], ids=lambda e: json.dumps(e))
def test_sweep_verdicts_match_jax(results, expected):
    assert repro.sweep_verdicts(results, expected, 0.3) == \
        jax_repro.sweep_verdicts(results, expected, 0.3)


def test_package_exports_the_repro_functions():
    import dwt_tpu_torch.utils as utils

    for name in ("accuracy_verdict", "check_cli_accuracy", "load_expect_table",
                 "sweep_verdicts"):
        assert getattr(utils, name) is getattr(repro, name)
