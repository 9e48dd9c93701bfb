"""Chaos runs of the port's digits trainer: every injected fault ends in exit 0 with a resumable checkpoint, or a diagnosed exit — never a hang or a torn state.

Each case spawns ``python -m dwt_tpu_torch.cli.usps_mnist --device cpu``
with a ``DWT_FAULT_PLAN`` in its environment and judges it from outside,
as a scheduler would (``tests/test_chaos.py`` for the JAX package).  One
composed case stays in tier-1: a slow step, a failed save write, a
preemption notice and a later SIGTERM; the relaunch then ends bitwise
equal (parameter digest) to an uninterrupted run.  The single-fault
matrix is marked ``slow``: each case is two or three interpreter
starts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from dwt_tpu_torch.resilience import WATCHDOG_EXIT_CODE, inject
from dwt_tpu_torch.utils.checkpoint import is_valid_checkpoint, latest_step, valid_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 4 steps an epoch (32 synthetic images, 8 per batch), a save every epoch.
BASE = ("--synthetic", "--synthetic_size", "32", "--source_batch_size", "8",
        "--target_batch_size", "8", "--test_batch_size", "16", "--group_size", "4",
        "--log_interval", "1", "--ckpt_every_epochs", "1", "--device", "cpu")


def _run(ck, plan=None, extra=(), timeout=240):
    """``(returncode, records, stderr)`` of one trainer process."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop(inject.ENV_VAR, None)
    if plan is not None:
        env[inject.ENV_VAR] = json.dumps(plan)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dwt_tpu_torch.cli.usps_mnist", *BASE,
         "--ckpt_dir", str(ck), *extra],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        _, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the run hung (plan {plan}): the one outcome chaos forbids")
    stderr = stderr.decode(errors="replace")
    records = []
    for line in stderr.splitlines():
        if line.startswith("{"):
            try:
                records.append(json.loads(line))
            except ValueError:
                pass
    return proc.returncode, records, stderr


def _kinds(records):
    return [r["kind"] for r in records]


def _digest(records):
    return [r["sha256"] for r in records if r["kind"] == "params_digest"][-1]


def _no_torn_steps(ck):
    for d in os.listdir(ck):
        if d.isdigit():
            assert is_valid_checkpoint(os.path.join(ck, d)), f"torn checkpoint {d}"


def test_chaos_composed_notice_then_sigterm_resumes_bitwise(tmp_path):
    rc, recs, err = _run(tmp_path / "ck", plan={
        "slow_step_at": 2, "slow_step_s": 0.3, "io_error_saves": 1,
        "notice_at_step": 3, "sigterm_at_step": 6},
        extra=("--epochs", "3", "--watchdog_timeout", "120"))
    assert rc == 0, err[-3000:]
    notice = [r for r in recs if r["kind"] == "notice_save"]
    assert [(r["step"], r["epoch"]) for r in notice] == [(3, 0)]
    pre = [r for r in recs if r["kind"] == "preempt"]
    assert [(r["step"], r["resume_step"]) for r in pre] == [(6, 3)]
    # The notice's save stands in for the final one: no second save at 6.
    assert valid_steps(tmp_path / "ck") == [3, 4]
    assert "test" in _kinds(recs)  # training went on past the notice
    _no_torn_steps(tmp_path / "ck")
    rc, resumed, err = _run(tmp_path / "ck", extra=("--epochs", "3"))
    assert rc == 0, err[-3000:]
    assert [(r["step"], r["data"]) for r in resumed if r["kind"] == "resume"] == [
        (4, "exact")]
    rc, whole, err = _run(tmp_path / "whole", extra=("--epochs", "3"))
    assert rc == 0, err[-3000:]
    assert _digest(resumed) == _digest(whole)
    assert latest_step(tmp_path / "ck") == 12


MATRIX = {
    # SIGTERM at a boundary: a final save there, exit 0, an exact resume.
    "sigterm": ({"sigterm_at_step": 6}, ("--epochs", "3"),
                {"rc": 0, "kinds": ["preempt"], "steps": [4, 6], "resume_bitwise": True}),
    # A hang: the watchdog's dump and its distinct exit code.
    "hang": ({"hang_at_step": 6}, ("--epochs", "3", "--watchdog_timeout", "5"),
             {"rc": WATCHDOG_EXIT_CODE, "stderr": "[watchdog]", "steps": [4]}),
    # A crash between the write and the finalize: diagnosed, the previous
    # step authoritative.
    "crash_in_save": ({"crash_in_save": 8}, ("--epochs", "3"),
                      {"rc": "nonzero", "stderr": "injected crash", "steps": [4]}),
    # Save writes failing within the retries: absorbed.
    "io_error_transient": ({"io_error_saves": 2}, ("--epochs", "2"),
                           {"rc": 0, "steps": [4, 8]}),
    # A dead filesystem: the save fails after its retries, diagnosed.
    "io_error_persistent": ({"io_error_saves": 99}, ("--epochs", "3"),
                            {"rc": "nonzero", "stderr": "injected I/O error",
                             "steps": []}),
    # A NaN under the rollback policy: the epoch checkpoint restored.
    "nan_rollback": ({"nan_at_step": 6}, ("--epochs", "3", "--guard_policy", "rollback",
                                          "--guard_interval", "1"),
                     {"rc": 0, "kinds": ["rollback"], "steps": [4, 8, 12]}),
    # A SIGKILL inside the delta promote: the stage stays invisible.
    "kill_mid_delta_promote": ({"kill_mid_delta_promote": 8},
                               ("--epochs", "3", "--ckpt_format", "delta"),
                               {"rc": -9, "steps": [4], "resume_bitwise": True}),
    # A corrupt item: quarantined and recorded, the run completes.
    "corrupt_item": ({"corrupt_items": {"source": [3]}}, ("--epochs", "2"),
                     {"rc": 0, "steps": [4, 8], "quarantine": 3}),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(MATRIX))
def test_chaos_matrix(name, tmp_path):
    plan, extra, want = MATRIX[name]
    ck = tmp_path / "ck"
    rc, recs, err = _run(ck, plan=plan, extra=extra)
    if want["rc"] == "nonzero":
        assert rc not in (0, WATCHDOG_EXIT_CODE), err[-3000:]
    else:
        assert rc == want["rc"], err[-3000:]
    for kind in want.get("kinds", ()):
        assert kind in _kinds(recs), name
    if "stderr" in want:
        assert want["stderr"] in err, err[-3000:]
    assert valid_steps(ck) == want["steps"], name
    _no_torn_steps(ck)
    if name == "hang":
        dumps = os.listdir(ck / "watchdog")
        assert dumps and "hang watchdog" in (ck / "watchdog" / dumps[0]).read_text()
    if "quarantine" in want:
        assert want["quarantine"] in json.load(open(ck / "quarantine.json"))["source"]
    if want.get("resume_bitwise"):
        rc, resumed, err = _run(ck, extra=extra)
        assert rc == 0, err[-3000:]
        assert "resume" in _kinds(resumed)
        rc, whole, err = _run(tmp_path / "whole", extra=extra)
        assert rc == 0, err[-3000:]
        assert _digest(resumed) == _digest(whole)
