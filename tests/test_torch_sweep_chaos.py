"""The sweep's composed-fault acceptance on the CPU: one pair's job SIGKILLed
inside a save (``sweep_job_kill_mid_save``), the other preempted
(``sweep_preempt_pairs``), the supervisor itself SIGKILLed inside its third
scheduling event (``kill_supervisor_at_schedule``: the journal written, the
spawn not yet made), and cross-run GC sweeping the shared blob store every 5
polls throughout.  The relaunch adopts or reschedules by the journal, and
every pair ends with final parameters bitwise equal to an undisturbed
sweep's (the ``params_digest`` records' SHA-256); ``tools/torch_ckpt_fsck.py
--store`` finds no referenced blob missing.
"""

import json
import os
import signal
import subprocess
import sys

from test_torch_sweep_e2e import (  # noqa: F401 — the fixture too
    REPO, TAGS, TINY_JOB, _few_threads, records, results, run_sweep)

from dwt_tpu_torch.sweep.journal import JOURNAL_NAME, SweepJournal

GC = ("--gc_every_polls", "5", "--gc_min_age_s", "2")
CHAOS = {"sweep_job_kill_mid_save": ["Art2Clipart"], "sweep_preempt_pairs": ["Clipart2Art"],
         "kill_supervisor_at_schedule": 3}
# Art2Clipart dies in its first save, at step 2, long before Clipart2Art's
# first train record is flushed (2 s) and the preemption parks it; a crash
# backoff of 10 s orders the reschedules: event 3 is Clipart2Art's, with
# Art2Clipart's crash already charged.
CHAOS_JOB = tuple(v if prev != "--ckpt_every_iters" else "2"
                  for prev, v in zip(("",) + TINY_JOB, TINY_JOB))
CHAOS_FLAGS = GC + ("--job_backoff_s", "10")


def test_composed_chaos_ends_bitwise_where_an_undisturbed_sweep_does(tmp_path):
    calm_root, chaos_root = tmp_path / "calm", tmp_path / "chaos"
    rc, out = run_sweep(calm_root, extra=CHAOS_FLAGS, job=CHAOS_JOB)
    assert rc == 0, out
    calm = results(calm_root)
    assert calm["completed"] == 2 and calm["respawns"] == {} == calm["preempt_resumes"], out

    # Schedule events 1 and 2 are the first spawns; event 3 is the first
    # fault-driven reschedule, where the supervisor dies.
    rc, out1 = run_sweep(chaos_root, plan=CHAOS, extra=CHAOS_FLAGS, job=CHAOS_JOB)
    assert rc == -signal.SIGKILL, out1
    journal = SweepJournal.load(os.path.join(str(chaos_root), JOURNAL_NAME))
    assert not journal.all_settled()
    assert "injecting fault plan" in out1

    rc, out2 = run_sweep(chaos_root, extra=CHAOS_FLAGS, job=CHAOS_JOB)
    assert rc == 0, out1 + out2
    chaos = results(chaos_root)
    assert chaos["completed"] == 2 and not chaos["quarantined"], out2
    assert chaos["pairs"] == calm["pairs"], (out1, out2)
    for tag in TAGS:
        ours = records(chaos_root, tag, "params_digest")[-1]
        ref = records(calm_root, tag, "params_digest")[-1]
        assert (ours["step"], ours["sha256"]) == (ref["step"], ref["sha256"]), tag
    # One crash charged to the pair killed in its save (its respawn starts
    # over: no save had finalized), one free resume of the preempted pair
    # from the step it parked at.
    assert chaos["respawns"] == {"Art2Clipart": 1}, (out1, out2)
    assert chaos["preempt_resumes"] == {"Clipart2Art": 1}, (out1, out2)
    (preempt,) = records(chaos_root, "Clipart2Art", "preempt")
    assert [r["step"] for r in records(chaos_root, "Clipart2Art", "resume")] == [preempt["step"]]
    assert records(chaos_root, "Art2Clipart", "resume") == []

    trees = [os.path.join(str(chaos_root), tag, "ckpt", tag) for tag in TAGS]
    fsck = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_ckpt_fsck.py"), "--store",
         os.path.join(str(chaos_root), "blobs"), *trees, "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    report = json.loads(fsck.stdout)
    assert report["blobs_missing"] == 0, fsck.stdout
    assert report["blobs_on_disk"] > 0 and report["torn_candidates"] == 0
    assert fsck.returncode == 0
