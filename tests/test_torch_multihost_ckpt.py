"""Port parity: the multi-process checkpoint plane of ``dwt_tpu_torch`` — the
host-shard writer, its promotion and restore, the boundary consensus, the
guard's mirror rung and a two-rank chaos case — against the JAX package's
counterparts (``tests/test_resilience.py``, ``tests/test_harvest.py``,
``tests/test_chaos.py``).

* ``save_host_shard``/``promote_host_shards``/restore: the restored state
  is bitwise the synchronous save's; a torn or missing shard refuses
  promotion and the previous step stays authoritative; a duplicate
  promotion is idempotent; a corrupted digest falls back; non-finite
  parameters write nothing; every port-written step passes the JAX
  package's ``checkpoint_invalid_reason``;
* the consensus of two ranks (gloo over localhost, spawned processes that
  import the port only) equals JAX's ``Coordinator`` combining the same
  rows;
* ``DivergenceGuard.mirror_recovery`` takes the remote rung from the
  snapshot both ranks hold, in the synchronous and the harvested mode;
* a SIGTERM to one rank of a two-rank digits run: both ranks save the same
  step and exit 0.  Under ``slow``, ``tests/test_chaos.py``'s other
  two-process cases: ``kill_writer_mid_shard`` (a rank dying inside its
  shard write), the exact resume after a SIGTERM, and a notice on one rank
  saving on both.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dwt_tpu.resilience.coord import Coordinator as JaxCoordinator
from dwt_tpu.utils.checkpoint import checkpoint_invalid_reason as jax_invalid_reason
from dwt_tpu_torch.ckpt.layout import latest_step, valid_steps
from dwt_tpu_torch.resilience.async_ckpt import MultiHostAsyncCheckpointer
from dwt_tpu_torch.resilience.coord import (
    EVENT_HALT,
    EVENT_NONE,
    EVENT_RECOVERED,
    EVENT_ROLLBACK,
)
from dwt_tpu_torch.resilience.guard import DivergenceGuard
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.utils.checkpoint import (
    MANIFEST,
    SHARD_MANIFEST,
    _mh_tmp_dir,
    host_state,
    promote_host_shards,
    restore_state,
    save_host_shard,
    save_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _tiny_state(step: int = 0, scale: float = 1.0) -> TrainState:
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(scale)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()  # momentum buffers exist
    return TrainState(model, opt, [lambda s: 0.1], step=step)


def _flat(state: TrainState):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _corrupt_shard(ck, step, proc=0):
    blob = os.path.join(_mh_tmp_dir(ck, step), f"shard_{proc}", "leaves.bin")
    with open(blob, "r+b") as f:
        f.truncate(os.path.getsize(blob) // 2)


def test_host_shard_save_promote_restore_byte_compatible(tmp_path):
    state = _tiny_state(step=3, scale=2.0)
    save_state(str(tmp_path / "sync"), 3, state)
    ck = str(tmp_path / "sh")
    host = host_state(state)
    assert save_host_shard(ck, 3, host, process_index=0)
    assert save_host_shard(ck, 3, host, process_index=1)
    assert valid_steps(ck) == [] and latest_step(ck) is None  # unpromoted
    path = promote_host_shards(ck, 3, process_count=2)
    assert valid_steps(ck) == [3]
    manifest = json.load(open(os.path.join(path, MANIFEST)))
    assert manifest["format"] == "host_shards" and manifest["process_count"] == 2
    assert sorted(os.listdir(path)) == [MANIFEST, "shard_0", "shard_1"]
    assert jax_invalid_reason(path) is None

    a, b = _tiny_state(), _tiny_state()
    assert restore_state(str(tmp_path / "sync"), a).step == 3
    assert restore_state(ck, b).step == 3
    for k, v in _flat(a).items():
        assert torch.equal(v, _flat(b)[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in sa["state"]:
        assert torch.equal(sa["state"][i]["momentum_buffer"],
                           sb["state"][i]["momentum_buffer"])


def test_host_shard_promotion_refuses_torn_shard(tmp_path):
    ck = str(tmp_path / "ck")
    good = _tiny_state(step=1)
    save_state(ck, 1, good)
    host = host_state(_tiny_state(step=2, scale=2.0))
    save_host_shard(ck, 2, host, process_index=0)
    save_host_shard(ck, 2, host, process_index=1)
    _corrupt_shard(ck, 2, proc=1)
    with pytest.raises(OSError, match="missing or torn"):
        promote_host_shards(ck, 2, process_count=2)
    assert latest_step(ck) == 1
    assert restore_state(ck, _tiny_state()).step == 1


def test_host_shard_duplicate_promotion_is_idempotent(tmp_path):
    state = _tiny_state(step=5)
    ck = str(tmp_path / "ck")
    acp = MultiHostAsyncCheckpointer()
    acp.save(ck, 5, state)
    acp.flush()
    acp.save(ck, 5, state)
    acp.flush()
    acp.promote_up_to(acp.done_seq)
    assert valid_steps(ck) == [5]
    acp.flush()
    assert restore_state(ck, _tiny_state()).step == 5
    assert jax_invalid_reason(os.path.join(ck, "5")) is None


def test_host_shard_missing_shard_refuses_promotion(tmp_path):
    ck = str(tmp_path / "ck")
    save_host_shard(ck, 2, _tiny_state(step=2), process_index=0)
    with pytest.raises(OSError, match="shard_1"):
        promote_host_shards(ck, 2, process_count=2)


def test_host_shard_digest_corruption_falls_back(tmp_path):
    ck = str(tmp_path / "ck")
    save_state(ck, 1, _tiny_state(step=1))
    save_host_shard(ck, 2, _tiny_state(step=2, scale=2.0), 0)
    promote_host_shards(ck, 2, process_count=1)
    mpath = os.path.join(ck, "2", "shard_0", SHARD_MANIFEST)
    manifest = json.load(open(mpath))
    size = os.path.getsize(mpath)
    manifest["params_digest"] = "0" * len(manifest["params_digest"])
    with open(mpath, "w") as f:
        f.write(json.dumps(manifest, indent=1).ljust(size))
    top = os.path.join(ck, "2", MANIFEST)
    manifest = json.load(open(top))
    manifest["params_digest"] = "0" * len(manifest["params_digest"])
    with open(top, "w") as f:
        json.dump(manifest, f)
    assert latest_step(ck) == 2  # size-valid...
    assert restore_state(ck, _tiny_state()).step == 1  # ...restore walks past it


def test_host_shard_refuses_nonfinite_params(tmp_path):
    state = _tiny_state(step=2)
    with torch.no_grad():
        next(state.model.parameters()).fill_(float("nan"))
    ck = str(tmp_path / "ck")
    assert not save_host_shard(ck, 2, state, 0)
    assert not os.path.exists(os.path.join(ck, ".tmp-mh-2", "shard_0"))


def test_multihost_async_ckpt_end_to_end_single_process(tmp_path):
    state = _tiny_state(step=5)
    ck = str(tmp_path / "ck")
    acp = MultiHostAsyncCheckpointer()
    assert acp.done_seq == -1
    acp.save(ck, 5, state)
    acp.flush()
    assert acp.done_seq == 1 and valid_steps(ck) == []
    acp.promote_up_to(acp.done_seq)
    assert valid_steps(ck) == [5]
    anchors = str(tmp_path / "ck" / "anchors")
    acp.save_multi([(ck, {}), (anchors, {})], 7, _tiny_state(step=7))
    acp.flush()
    assert acp.done_seq == 2
    acp.promote_up_to(2)
    assert valid_steps(ck) == [5, 7] and valid_steps(anchors) == [7]
    for step in (5, 7):
        assert jax_invalid_reason(os.path.join(ck, str(step))) is None


# ----------------------------------------------------- two-rank consensus


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CONSENSUS = textwrap.dedent("""
    import json, sys
    import torch
    from dwt_tpu_torch import parallel
    from dwt_tpu_torch.resilience.coord import Coordinator
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(2)
    parallel.initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    coord = Coordinator()
    rows = json.loads(sys.argv[4])
    got = []
    for row in rows:
        d = coord.decide(stop=row[rank][0], event=row[rank][1], rollback_step=row[rank][2],
                         save_done_seq=row[rank][3], notice=row[rank][4])
        got.append([d.stop, d.event, d.rollback_step, d.save_done_seq, d.notice])
    got.append(coord.agree_step(10 + rank))
    json.dump(got, open(out, "w"))
    parallel.shutdown_distributed()
""")


def _jax_decision(rows):
    """JAX's Coordinator combining the two ranks' vectors."""
    coord = JaxCoordinator(enabled=True)
    coord._allgather = lambda values: np.asarray(rows, np.int32)
    d = coord.decide(stop=False)
    return [d.stop, d.event, d.rollback_step, d.save_done_seq, d.notice]


def test_two_rank_consensus_equals_the_jax_combination(tmp_path):
    cases = [
        [[0, EVENT_NONE, -1, -1, 0], [0, EVENT_NONE, -1, -1, 0]],
        [[1, EVENT_NONE, -1, 3, 0], [0, EVENT_RECOVERED, 4, 2, 1]],
        [[0, EVENT_ROLLBACK, 9, 5, 0], [0, EVENT_HALT, -1, 5, 0]],
        [[0, EVENT_RECOVERED, 7, 1, 1], [1, EVENT_ROLLBACK, 8, 0, 0]],
    ]
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
    env.update(DWT_DIST_TIMEOUT_S="60", PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", CONSENSUS, str(r), str(port),
                               str(tmp_path / f"c{r}.json"), json.dumps(cases)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = [json.load(open(tmp_path / f"c{r}.json")) for r in range(2)]
    assert got[0] == got[1]
    for case, decision in zip(cases, got[0]):
        want = _jax_decision(case)
        assert [bool(decision[0]), decision[1], decision[2], decision[3],
                bool(decision[4])] == [bool(want[0]), want[1], want[2], want[3],
                                       bool(want[4])]
    assert got[0][-1] == 10  # agree_step: the smallest proposal


# ------------------------------------------------------ the mirror rung


def _ladder_state(tag: float = 1.0) -> TrainState:
    model = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(tag)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1), [lambda s: 0.1])


def _tag(state: TrainState) -> float:
    return float(state.model.weight.detach()[0, 0])


def test_guard_mirror_recovery_takes_same_rung():
    """tests/test_resilience.py: the mirror host takes the backoff rung,
    then (still backed off) the skip escalation."""
    guard = DivergenceGuard("skip_step", interval=1, lr_backoff=0.5, backoff_recovery=100,
                            keep_previous=True)
    state = _ladder_state()
    guard.prime(state)
    guard.mirror_recovery(state, 3)
    assert state.lr_scale == 0.5 and guard.in_backoff
    guard.mirror_recovery(state, 4)
    assert state.lr_scale == 0.5 and guard.recoveries == 2


def test_guard_mirror_reverts_to_pre_refresh_snapshot():
    """A rank whose check passed at this boundary refreshed its snapshot;
    the mirror reverts to the one both ranks hold (the previous check's)."""
    guard = DivergenceGuard("skip_step", interval=1, keep_previous=True)
    state = _ladder_state(1.0)
    guard.prime(state)
    with torch.no_grad():
        state.model.weight.fill_(2.0)
    ok = {"loss": torch.ones(()), "grad_norm": torch.ones(())}
    guard.step(state, ok, 1, 1)  # passing check refreshes to 2.0
    assert _tag(state) == 2.0
    guard.mirror_recovery(state, 1)
    assert _tag(state) == 1.0
    with pytest.raises(RuntimeError, match="keep_previous"):
        g = DivergenceGuard("skip_step", interval=1)
        g.prime(_ladder_state())
        g.mirror_recovery(_ladder_state(), 1)


def test_mirror_recovery_aligns_with_firing_hosts_history():
    """tests/test_harvest.py: under harvesting the mirror discards the
    snapshots at and after the firing rank's bad step, so both revert to
    the same state."""

    def build():
        g = DivergenceGuard("skip_step", interval=1)
        g.prime(_ladder_state(0.0))
        g.enable_harvest(2, 0)
        for s in (1, 2):
            g.check_harvested(_ladder_state(float(s)), 1, s)
        return g

    firing, mirror = build(), build()
    firing.observe_flags(2, 2, np.asarray(False))
    fired = _ladder_state(3.0)
    firing.check_harvested(fired, 1, 3)
    mirrored = _ladder_state(3.0)
    mirror.check_harvested(mirrored, 1, 3)
    assert firing.last_bad_step == 2
    mirror.mirror_recovery(mirrored, 3, bad_step=firing.last_bad_step)
    assert _tag(fired) == _tag(mirrored) == 1.0


# -------------------------------------------------------- two-rank chaos


DIGITS = ["--synthetic", "--synthetic_size", "64", "--distributed", "--data_parallel",
          "--group_size", "4", "--source_batch_size", "8", "--target_batch_size", "8",
          "--test_batch_size", "8", "--num_workers", "0", "--device", "cpu",
          "--epochs", "2", "--ckpt_every_epochs", "1", "--log_interval", "1"]


def _digits_pair(tmp_path, name, extra=(), plans=(None, None), timeout=180, ck="ck",
                 trail=None):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
        env.update(DWT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", DWT_NUM_PROCESSES="2",
                   DWT_PROCESS_ID=str(rank), DWT_DIST_TIMEOUT_S="30",
                   PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        if plans[rank] is not None:
            env["DWT_FAULT_PLAN"] = json.dumps(plans[rank])
        if trail is not None:
            env["DWT_DATA_TRAIL"] = str(tmp_path / f"trail_{trail}_{rank}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dwt_tpu_torch.cli.usps_mnist", *DIGITS, *extra,
             "--ckpt_dir", str(tmp_path / ck),
             "--metrics_jsonl", str(tmp_path / f"{name}_{rank}.jsonl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    records = [[json.loads(line) for line in open(tmp_path / f"{name}_{r}.jsonl")
                if line.strip()] for r in range(2)]
    return [p.returncode for p in procs], outs, records


def test_sigterm_to_one_rank_saves_on_both_and_exits_zero(tmp_path):
    """rank 1 alone gets a SIGTERM at step 3: the consensus stops both at
    that boundary, both save the step (rank 0 promotes its shards) and
    exit 0."""
    rcs, outs, records = _digits_pair(tmp_path, "term", plans=(None, {"sigterm_at_step": 3}))
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    pre = [[r for r in recs if r["kind"] == "preempt"] for recs in records]
    assert len(pre[0]) == len(pre[1]) == 1 and pre[0][0]["step"] == pre[1][0]["step"] == 3
    assert valid_steps(str(tmp_path / "ck")) == [3]
    step_dir = tmp_path / "ck" / "3"
    assert (step_dir / "shard_0").is_dir() and (step_dir / "shard_1").is_dir()
    assert jax_invalid_reason(str(step_dir)) is None


@pytest.mark.slow
def test_kill_writer_mid_shard_leaves_the_previous_step_authoritative(tmp_path):
    """rank 1 dies inside its shard write of the epoch-2 save (step 16):
    the step is never promoted (rank 0 fails at the next collective's
    timeout), the epoch-1 step stays the newest valid, and a relaunch
    resumes from it and finishes."""
    rcs, _, _ = _digits_pair(tmp_path, "kill", plans=(None, {"kill_writer_mid_shard": 16}))
    assert rcs[1] == -signal.SIGKILL and rcs[0] != 0
    assert valid_steps(str(tmp_path / "ck")) == [8]
    rcs, outs, records = _digits_pair(tmp_path, "again")
    assert rcs == [0, 0], outs[0][-2000:]
    resumes = [r for r in records[0] if r["kind"] == "resume"]
    assert resumes and resumes[0]["step"] == 8
    assert 16 in valid_steps(str(tmp_path / "ck"))


def _trail(path, role):
    with open(os.path.join(path, f"{role}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.slow
def test_two_rank_sharded_exact_resume(tmp_path):
    """tests/test_chaos.py's two-process exact resume: a SIGTERM to rank 1
    at step 6, the relaunch resumes both ranks exactly (``data: exact``),
    and each rank's batches after the resume are its uninterrupted twin's."""
    quiet = ("--ckpt_every_epochs", "1000")
    rcs, outs, _ = _digits_pair(tmp_path, "gold", quiet + ("--epochs", "3"), ck="ck_gold",
                                trail="gold")
    assert rcs == [0, 0], outs[0][-2000:]
    rcs, outs, _ = _digits_pair(tmp_path, "kill", quiet + ("--epochs", "500"),
                                plans=(None, {"sigterm_at_step": 6}), ck="ck_kill",
                                trail="kill")
    assert rcs == [0, 0], outs[1][-2000:]
    ck = str(tmp_path / "ck_kill")
    assert latest_step(ck) == 6
    ds = json.load(open(os.path.join(ck, "6", MANIFEST)))["data_state"]
    assert (ds["streams"]["source"]["epoch"], ds["streams"]["source"]["cursor"]) == (0, 6)
    rcs, outs, records = _digits_pair(tmp_path, "resume", quiet + ("--epochs", "3"),
                                      ck="ck_kill", trail="kill")
    assert rcs == [0, 0], outs[0][-2000:]
    for recs in records:
        res = [r for r in recs if r["kind"] == "resume"][-1]
        assert res["step"] == 6 and res["data"] == "exact"
    for rank in range(2):
        for role in ("source", "target"):
            gold = {(r["epoch"], r["cursor"]): r["ids"]
                    for r in _trail(str(tmp_path / f"trail_gold_{rank}"), role)}
            rows = _trail(str(tmp_path / f"trail_kill_{rank}"), role)
            at = max(i for i, r in enumerate(rows) if (r["epoch"], r["cursor"]) == (0, 6))
            tail = [((r["epoch"], r["cursor"]), r["ids"]) for r in rows[at:]]
            assert [k for k, _ in tail] == [(0, 6), (0, 7)] + [
                (e, c) for e in (1, 2) for c in range(8)]
            for key, ids in tail:
                assert ids == gold[key], (rank, role, key)


@pytest.mark.slow
def test_two_rank_notice_on_one_rank_saves_on_both(tmp_path):
    """tests/test_chaos.py: a notice on rank 0 alone is a proactive save on
    both ranks at the same step; the later SIGTERM on rank 1 exits both
    with that save as the resume step, without a second save."""
    rcs, outs, records = _digits_pair(
        tmp_path, "notice", ("--epochs", "500", "--ckpt_every_epochs", "1000"),
        plans=({"notice_at_step": 3}, {"sigterm_at_step": 6}))
    assert rcs == [0, 0], outs[0][-2000:]
    saves = [[r["step"] for r in recs if r["kind"] == "notice_save"] for recs in records]
    pre = [[r for r in recs if r["kind"] == "preempt"][-1] for recs in records]
    assert saves == [[3], [3]]
    assert [p["resume_step"] for p in pre] == [3, 3] and [p["step"] for p in pre] == [6, 6]
    ck = str(tmp_path / "ck")
    assert latest_step(ck) == 3 and not os.path.isdir(os.path.join(ck, "6"))
    assert json.load(open(os.path.join(ck, "3", MANIFEST)))["format"] == "host_shards"
