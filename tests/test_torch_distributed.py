"""The port's multi-process bring-up end to end: two ranks of
``python -m dwt_tpu_torch.cli.usps_mnist --distributed --data_parallel`` on
the CPU (gloo over localhost, the DWT_* variables, two torch threads each,
every collective under a 60 s timeout), held to the assertions of the JAX
package's ``tests/test_distributed.py``:

* a global eval count of 32 on both ranks, with equal accuracy and loss;
* equal, nonzero ``params_digest`` records and equal final steps;
* one valid checkpoint with ``shard_0`` and ``shard_1``, manifest
  ``format: host_shards`` and ``process_count: 2``, which the JAX
  package's validity check accepts.

Also: the train records equal a one-process run at the same global batch
to float reassociation (``rtol=1e-3``: Adam turns reassociation noise in a
near-zero gradient into a full ±lr update, as in JAX's DP parity test);
each step's two rank batches are, together, the one-process batch's items
(the batch-id trail), and the shard split's arrays reorder bitwise into the
unsharded batch; ``batch_iterator(shard=...)`` is the JAX loader's bitwise
(the stride split, the padded eval tail, the resume cursor, quarantine
substitution); a two-rank resume from the one-epoch checkpoint continues
bitwise (the parameters' SHA-256 of an uninterrupted two-epoch run).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from dwt_tpu.utils.checkpoint import is_valid_checkpoint as jax_is_valid
from dwt_tpu_torch.data.datasets import ArrayDataset
from dwt_tpu_torch.data.loader import batch_iterator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--synthetic", "--synthetic_size", "64", "--steps_per_dispatch", "2",
        "--group_size", "4", "--source_batch_size", "8", "--target_batch_size", "8",
        "--test_batch_size", "8", "--num_workers", "0", "--device", "cpu",
        "--log_interval", "1", "--ckpt_every_epochs", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _last(records, kind):
    matches = [r for r in records if r["kind"] == kind]
    assert matches, f"no {kind!r} record logged"
    return matches[-1]


def _run(tmp_path, name, world, extra=()):
    """``world`` ranks of the digits CLI; their records, by rank."""
    return _wait(tmp_path, name, _start(tmp_path, name, world, extra))


def _start(tmp_path, name, world, extra=()):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", DWT_DIST_TIMEOUT_S="60",
                   DWT_DATA_TRAIL=str(tmp_path / f"trail_{name}_{rank}"))
        flags = list(ARGS) + list(extra)
        if world > 1:
            env.update(DWT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       DWT_NUM_PROCESSES=str(world), DWT_PROCESS_ID=str(rank))
            flags += ["--distributed", "--data_parallel"]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dwt_tpu_torch.cli.usps_mnist", *flags,
             "--metrics_jsonl", str(tmp_path / f"{name}_{rank}.jsonl")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO))
    return procs


def _wait(tmp_path, name, procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"
    return [_read(tmp_path / f"{name}_{r}.jsonl") for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    ck = str(tmp / "shared_ck")
    two = _run(tmp, "two", 2, ["--epochs", "1", "--ckpt_dir", ck])
    one = _run(tmp, "one", 1, ["--epochs", "1"])
    return tmp, ck, two, one


def test_two_rank_digits_cli_meets_the_jax_distributed_assertions(runs):
    tmp, ck, (rec0, rec1), _ = runs
    t0, t1 = _last(rec0, "test"), _last(rec1, "test")
    assert t0["count"] == 32 and t1["count"] == 32
    assert t0["accuracy"] == t1["accuracy"]
    assert t0["loss"] == pytest.approx(t1["loss"], rel=1e-6)
    d0, d1 = _last(rec0, "params_digest"), _last(rec1, "params_digest")
    assert d0["digest"] == d1["digest"] != 0.0 and d0["sha256"] == d1["sha256"]
    assert _last(rec0, "test")["step"] == _last(rec1, "test")["step"] > 0
    first = [rec0[0], rec1[0]]
    assert [r["kind"] for r in first] == ["distributed", "distributed"]
    assert [r["rank"] for r in first] == [0, 1]
    assert all(r["backend"] == "gloo" and r["devices"] == ["cpu", "cpu"]
               and r["captured_steps"] is False for r in first)

    step = _last(rec0, "test")["step"]
    path = os.path.join(ck, str(step))
    assert os.path.isdir(path) and jax_is_valid(path)
    assert os.path.isdir(os.path.join(path, "shard_0"))
    assert os.path.isdir(os.path.join(path, "shard_1"))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["format"] == "host_shards" and manifest["process_count"] == 2


def test_two_rank_records_and_batches_match_one_process(runs):
    tmp, _, (rec0, rec1), (single,) = runs
    trains = lambda recs: [r for r in recs if r["kind"] == "train"]
    assert len(trains(rec0)) == len(trains(single)) == 8
    for a, b, c in zip(trains(rec0), trains(rec1), trains(single)):
        assert a["step"] == b["step"] == c["step"]
        for key in ("loss", "cls_loss", "entropy_loss", "grad_norm"):
            assert a[key] == b[key]
            assert a[key] == pytest.approx(c[key], rel=1e-3), (a["step"], key)
    t2, t1 = _last(rec0, "test"), _last(single, "test")
    assert t2["count"] == t1["count"] == 32

    for role in ("source", "target"):
        rows = [_read(tmp / f"trail_{n}" / f"{role}.jsonl") for n in ("two_0", "two_1", "one_0")]
        assert len(rows[0]) == len(rows[1]) == len(rows[2]) == 8
        for a, b, c in zip(*rows):
            assert sorted(a["ids"] + b["ids"]) == sorted(c["ids"])


def test_shard_split_reorders_bitwise_into_the_unsharded_batch():
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.normal(size=(70, 5, 5, 1)).astype(np.float32),
                      rng.integers(0, 10, size=70))
    whole = list(batch_iterator(ds, 8, seed=3, epoch=1))
    parts = [list(batch_iterator(ds, 4, seed=3, epoch=1, shard=(r, 2))) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 8
    for w, a, b in zip(whole, *parts):
        for f in range(2):
            merged = np.empty_like(w[f])
            merged[0::2], merged[1::2] = a[f], b[f]
            assert np.array_equal(merged, w[f])


class _Bad:
    """Items 0..n-1 of a seeded array; the ``bad`` ones raise (quarantined)."""

    def __init__(self, n, bad=()):
        rng = np.random.default_rng(1)
        self.x = rng.normal(size=(n, 3)).astype(np.float32)
        self.bad = set(bad)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        if i in self.bad:
            raise OSError(f"bad item {i}")
        return self.x[i], np.int64(i)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True, seed=3, epoch=1),
    dict(shuffle=True, drop_last=True, seed=3, epoch=1, start_batch=1),
    dict(shuffle=True, drop_last=True, seed=3, epoch=1, substitute=True, bad=(4, 9, 31)),
    dict(shuffle=True, drop_last=True, seed=3, epoch=1, substitute=True, bad=(4, 9, 31),
         start_batch=1),
    dict(shuffle=False, drop_last=False, pad_and_mask=True),
    dict(shuffle=False, drop_last=False, pad_and_mask=True, bad=(2, 40)),
], ids=["train", "cursor", "substitute", "substitute_cursor", "eval_tail", "eval_bad"])
@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (3, 4)])
def test_shard_split_is_the_jax_loaders_bitwise(kw, shard):
    """``batch_iterator(shard=...)`` against the JAX loader's: the stride
    split, the padded eval tail, the resume cursor and quarantine
    substitution, batch for batch, bitwise."""
    from dwt_tpu.data.loader import batch_iterator as jax_batch_iterator

    kw = dict(kw)
    bad = kw.pop("bad", ())
    ours = list(batch_iterator(_Bad(43, bad), 4, shard=shard, **kw))
    ref = list(jax_batch_iterator(_Bad(43, bad), 4, shard=shard, **kw))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert np.array_equal(np.asarray(u), np.asarray(v))


def test_two_rank_resume_continues_bitwise(runs):
    tmp, ck, _, _ = runs
    pairs = {name: _start(tmp, name, 2, ["--epochs", "2", "--ckpt_dir", d])
             for name, d in (("resume", ck), ("straight", str(tmp / "ck2")))}
    resumed, straight = (_wait(tmp, name, procs) for name, procs in pairs.items())
    for rank in range(2):
        assert _last(resumed[rank], "resume")["step"] == 8
        assert (_last(resumed[rank], "params_digest")["sha256"]
                == _last(straight[rank], "params_digest")["sha256"])
    assert jax_is_valid(os.path.join(ck, "16"))
