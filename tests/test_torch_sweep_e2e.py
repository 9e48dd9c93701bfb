"""The port's sweep end to end on the CPU: ``python -m dwt_tpu_torch.sweep.cli``
over real tiny OfficeHome training jobs (``dwt_tpu_torch.cli.officehome_sweep``
with ``--device cpu``), one pair preempted by the supervisor's injected
``sweep_preempt_pairs``: notice, SIGTERM, the loop's save and exit 0, a free
reschedule, and both pairs complete.  The composed-fault case is
``tests/test_torch_sweep_chaos.py``, the supervisor's drain
``tests/test_torch_sweep_drain.py``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from dwt_tpu_torch.resilience import inject

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = "Art:Clipart,Clipart:Art"
TAGS = ("Art2Clipart", "Clipart2Art")
# A tiny synthetic pair: 24 steps, so that an injected preemption lands
# between the first flushed train record (the logger flushes its file every
# 2 s) and the finish line.
TINY_JOB = (
    "--synthetic", "--synthetic_size", "12", "--arch", "tiny",
    "--img_crop_size", "32", "--num_classes", "5",
    "--source_batch_size", "6", "--test_batch_size", "6",
    "--num_iters", "24", "--check_acc_step", "12",
    "--stat_collection_passes", "1", "--log_interval", "1",
    "--group_size", "4", "--ckpt_every_iters", "6", "--device", "cpu",
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def sweep_env(plan=None):
    """The supervisor's environment: two threads a job, the plan if any."""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop(inject.ENV_VAR, None)
    if plan is not None:
        env[inject.ENV_VAR] = json.dumps(plan)
    return env


def run_sweep(root, plan=None, extra=(), job=TINY_JOB, timeout=300):
    argv = [sys.executable, "-m", "dwt_tpu_torch.sweep.cli", "--sweep_root", str(root),
            "--pairs", PAIRS, "--slots", "2", "--poll_interval_s", "0.2",
            "--job_backoff_s", "0.5", *extra, "--", *job]
    proc = subprocess.Popen(argv, cwd=REPO, env=sweep_env(plan), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail("the sweep supervisor hung")
    return proc.returncode, out.decode(errors="replace")


def results(root):
    with open(os.path.join(str(root), "results.json")) as f:
        return json.load(f)


def records(root, tag, kind):
    path = os.path.join(str(root), tag, f"metrics.{tag}.jsonl")
    return [r for r in map(json.loads, open(path)) if r["kind"] == kind]


def test_sweep_with_an_injected_preemption_completes_every_pair(tmp_path):
    root = tmp_path / "sweep"
    rc, out = run_sweep(root, plan={"sweep_preempt_pairs": ["Art2Clipart"]})
    assert rc == 0, out
    res = results(root)
    assert res["completed"] == 2 and not res["quarantined"], out
    assert set(res["pairs"]) == {"Art->Clipart", "Clipart->Art"}
    # The preempted pair resumed for free: no crash respawn charged.
    assert res["preempt_resumes"] == {"Art2Clipart": 1}, out
    assert res["respawns"] == {}, out
    # It parked through the loop's save-and-exit: the fsync'd preempt
    # record, then a resume from the step it saved.
    (preempt,) = records(root, "Art2Clipart", "preempt")
    (resume,) = records(root, "Art2Clipart", "resume")
    assert resume["step"] == preempt["step"] < 24
    assert records(root, "Clipart2Art", "preempt") == []
    # Both pairs train on the same synthetic data from the same seed, so
    # the preempted pair ends bitwise where the undisturbed one does.
    digests = {tag: records(root, tag, "params_digest")[-1]["sha256"] for tag in TAGS}
    assert digests["Art2Clipart"] == digests["Clipart2Art"]
    journal = json.load(open(root / "sweep.json"))["pairs"]
    assert journal["Art2Clipart"]["attempts"] == 2 and journal["Clipart2Art"]["attempts"] == 1
