"""The serving fan-out's generations: a hot swap, a rollback and an adapted generation on every rank.

Two replica ranks of ``python -m dwt_tpu_torch.serve.server --distributed
--data_parallel --device cpu`` (``tests/torch_fanout_ranks.py``) serve
LeNet-DWT from a port checkpoint:

* ``--watch``: a checkpoint written under traffic goes live on both ranks
  with no failed request; a ``--rollback_rules`` file whose rule trips on
  the new version's window rolls it back under traffic, again with no
  failed request; every access record's batch is single-version; after
  the swap and after the rollback both ranks report one generation and
  one generation digest (``GET /fanout?digest=1``), the rollback's that of
  the boot generation;
* ``--adapt_every``, replica and gspmd (``1,1,2`` under ``model``, where
  the front's collect gathers the generation's blocks from every rank):
  one 8-row request folds into an adapted generation whose version (its
  label digests the folded stats) equals a one-process ``DomainAdapter``'s
  on the same rows, and which reaches both ranks.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from dwt_tpu_torch.fleet import DeployController
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.serve import ServeEngine
from dwt_tpu_torch.serve.adapt import DomainAdapter
from dwt_tpu_torch.utils import checkpoint as ckpt

from torch_fanout_ranks import Ranks

torch.set_num_threads(2)

SHAPE = (28, 28, 1)


def _save(d, step, perturb=0.0):
    model = build_lenet(group_size=4, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("cov"):
                m = torch.randn(buf.shape, generator=gen)
                buf.copy_(m @ m.transpose(-1, -2) / 4 + 0.5 * torch.eye(buf.shape[-1]))
            elif name.endswith("mean"):
                buf.copy_(0.2 * torch.randn(buf.shape, generator=gen))
        for p in model.parameters():
            p.add_(perturb)
    host = ckpt.HostState({"model": {k: v.clone() for k, v in model.state_dict().items()},
                           "optimizer": {"state": {}, "param_groups": []},
                           "step": step, "lr_scale": 1.0},
                          tuple(n for n, _ in model.named_parameters()))
    ckpt.save_state(str(d), step, host)


class _Traffic:
    """Client threads sending small requests until paused or stopped;
    every reply's version and every failure kept."""

    def __init__(self, ranks: Ranks, threads: int = 2):
        self.ranks = ranks
        self.versions, self.failures = [], []
        self.go, self.done = threading.Event(), threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,)) for i in range(threads)]
        for t in self._threads:
            t.start()

    def _run(self, i):
        from dwt_tpu_torch.serve.server import HttpServeClient

        client = HttpServeClient("127.0.0.1", self.ranks.ready["port"], timeout=60.0)
        x = np.random.default_rng(i).normal(size=(1 + i,) + SHAPE).astype(np.float32)
        while not self.done.is_set():
            if not self.go.wait(0.05):
                continue
            try:
                self.versions.append(client.infer_reply(x)["version"])
            except Exception as e:  # a failed request: the test's finding
                self.failures.append(repr(e))
            time.sleep(0.01)
        client.close()

    def stop(self):
        self.done.set()
        for t in self._threads:
            t.join(timeout=60)


def _wait_version(ranks, pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, health = ranks.client.healthz()
        assert status == 200, health
        if pred(health["version"]):
            return health["version"]
        time.sleep(0.05)
    raise AssertionError(f"{what}: still {health['version']}")


def _one_generation(ranks):
    report = ranks.fanout(digest=True)["ranks"]
    assert len({(r["gen"], r["version"], r["digest"]) for r in report}) == 1, report
    return report[0]


def test_watch_swap_and_rollback_land_on_every_rank(tmp_path):
    d = tmp_path / "ck"
    _save(d, 1)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([{"name": "any_window", "metric": "served", "op": ">=",
                                  "threshold": 1}]))
    access = tmp_path / "access.jsonl"
    ranks = Ranks(tmp_path, 2, [
        "--model", "lenet", "--ckpt_dir", str(d), "--buckets", "1,4", "--data_parallel",
        "--max_batch_delay_ms", "2", "--watch", "--reload_poll_s", "0.2",
        "--access_log", str(access), "--rollback_rules", str(rules),
        "--rollback_min_requests", "30", "--rollback_decide_s", "600", "--canary_batch", "4"])
    traffic = None
    try:
        v1 = ranks.ready["version"]
        boot = _one_generation(ranks)
        traffic = _Traffic(ranks)
        traffic.go.set()
        time.sleep(0.5)
        _save(d, 2, perturb=0.01)
        v2 = _wait_version(ranks, lambda v: v != v1, "the swap")
        traffic.go.clear()
        time.sleep(0.3)
        swapped = _one_generation(ranks)
        assert swapped["version"] == v2 and swapped["gen"] > 0
        assert swapped["digest"] != boot["digest"]
        traffic.go.set()
        _wait_version(ranks, lambda v: v == v1, "the rollback")
        traffic.go.clear()
        time.sleep(0.3)
        back = _one_generation(ranks)
        assert (back["gen"], back["digest"]) == (boot["gen"], boot["digest"])
        traffic.stop()
        assert not traffic.failures, traffic.failures[:3]
        assert {v1, v2} <= set(traffic.versions)
    finally:
        if traffic is not None:
            traffic.stop()
        rcs = ranks.stop()
        ranks.kill()
    assert rcs == [0, 0], ranks.stderr(0)[-2000:]
    records = [json.loads(line) for line in open(access)]
    batches = {}
    for r in records:
        if r["kind"] == "access":
            assert r["status"] == "ok", r
            assert batches.setdefault(r["batch_seq"], r["version"]) == r["version"]
    kinds = [r["kind"] for r in records if r["kind"] != "access"]
    assert kinds.count("swap") == 1 and kinds.count("rollback") == 1, kinds


@pytest.mark.parametrize("plan", [["--data_parallel"],
                                  ["--mesh_shape", "1,1,2", "--sharding_rules", "model"]],
                         ids=["replica", "gspmd"])
def test_adapted_generation_reaches_every_rank(tmp_path, plan):
    d = tmp_path / "ck"
    _save(d, 1)
    x = np.random.default_rng(5).normal(0.3, 1.2, size=(8,) + SHAPE).astype(np.float32)
    # The one-process adapter on the same rows.
    engine = ServeEngine.from_checkpoint(str(d), build_lenet(group_size=4), SHAPE,
                                         buckets=(1, 8), device="cpu")
    adapter = DomainAdapter(engine, DeployController(engine), adapt_every_s=0.3,
                            min_samples=8, collect_batch=4)
    adapter.offer(x, 8)
    adapter._absorb(adapter._drain_queue())
    assert adapter.try_fold() == "swapped"
    want = engine.version.label
    ranks = Ranks(tmp_path, 2, [
        "--model", "lenet", "--ckpt_dir", str(d), "--buckets", "1,8", *plan,
        "--max_batch_delay_ms", "2", "--adapt_every", "0.3", "--adapt_min_samples", "8",
        "--adapt_batch", "4", "--rollback_decide_s", "600"])
    try:
        v1 = ranks.ready["version"]
        boot = _one_generation(ranks)
        assert ranks.client.infer_reply(x)["version"] == v1
        got = _wait_version(ranks, lambda v: v != v1, "the adapted generation")
        assert got == want
        adapted = _one_generation(ranks)
        assert adapted["version"] == want and adapted["digest"] != boot["digest"]
        assert ranks.client.infer_reply(x)["version"] == want
    finally:
        rcs = ranks.stop()
        ranks.kill()
    assert rcs == [0, 0], ranks.stderr(0)[-2000:]
