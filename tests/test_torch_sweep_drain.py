"""The sweep supervisor's drain on the CPU: a SIGTERM to
``python -m dwt_tpu_torch.sweep.cli`` mid-sweep warns and parks every real
tiny training job, the supervisor exits 0, and the same command again
completes the matrix with each pair's resume free.
"""

import signal
import subprocess
import sys
import time

from test_torch_sweep_e2e import (  # noqa: F401 — the fixture too
    PAIRS, REPO, TAGS, TINY_JOB, _few_threads, records, results, run_sweep, sweep_env)


def test_supervisor_drain_parks_every_job_and_the_relaunch_finishes(tmp_path):
    """SIGTERM to the supervisor mid-sweep: every job warned and parked
    (exit 0, a ``preempt`` record), the supervisor exits 0 drained; the same
    command again completes the matrix."""
    root = tmp_path / "sweep"
    argv = [sys.executable, "-m", "dwt_tpu_torch.sweep.cli", "--sweep_root", str(root),
            "--pairs", PAIRS, "--slots", "2", "--poll_interval_s", "0.2", "--", *TINY_JOB]
    proc = subprocess.Popen(argv, cwd=REPO, env=sweep_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    metrics = [root / tag / f"metrics.{tag}.jsonl" for tag in TAGS]
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and proc.poll() is None:
        if all(m.exists() and '"train"' in m.read_text() for m in metrics):
            break
        time.sleep(0.1)
    assert proc.poll() is None, proc.communicate()[0].decode()
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    out = out.decode(errors="replace")
    assert proc.returncode == 0, out
    assert "drained" in out
    assert results(root)["drained"] is True
    assert all(len(records(root, tag, "preempt")) == 1 for tag in TAGS), out

    rc, out2 = run_sweep(root)
    assert rc == 0, out + out2
    res = results(root)
    assert res["completed"] == 2 and not res["quarantined"] and not res["drained"], out2
    assert res["preempt_resumes"] == {tag: 1 for tag in TAGS}
