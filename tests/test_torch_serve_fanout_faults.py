"""The serving fan-out's drain and failure, and what its ranks import.

Ranks of ``python -m dwt_tpu_torch.serve.server --distributed --device
cpu`` (``tests/torch_fanout_ranks.py``, ``DWT_DIST_TIMEOUT_S`` 20 s):

* SIGTERM to the front under traffic: the queue drains, no request fails,
  every rank exits 0; SIGTERM to every rank at once (as torchrun signals
  a group): the followers keep serving until the front's stop, every rank
  exits 0;
* SIGKILL of a follower: the next request gets an error reply, ``/healthz``
  answers 503, and the front exits 1 well inside the collective timeout;
* neither the front nor a follower loads ``jax`` or ``dwt_tpu``.
"""

from __future__ import annotations

import signal
import threading
import time

import numpy as np

from torch_fanout_ranks import TIMEOUT_S, Ranks

SHAPE = (28, 28, 1)
FLAGS = ["--model", "lenet", "--init_random", "--buckets", "1,8", "--max_batch_delay_ms", "2"]


def test_sigterm_to_the_front_drains_every_rank(tmp_path):
    ranks = Ranks(tmp_path, 2, FLAGS + ["--data_parallel"])
    failures, served = [], []

    def client(i):
        from dwt_tpu_torch.serve.batcher import ShedError
        from dwt_tpu_torch.serve.server import HttpServeClient

        c = HttpServeClient("127.0.0.1", ranks.ready["port"], timeout=60.0)
        x = np.zeros((3,) + SHAPE, np.float32)
        for _ in range(20):
            try:
                served.append(c.infer(x).shape)
            except (ShedError, ConnectionError):
                break  # the drain's 503 refuses new requests; a closed socket after it
            except Exception as e:
                failures.append(repr(e))
                break
        c.close()

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        rcs = ranks.stop()
        for t in threads:
            t.join(timeout=60)
        summary = ranks.summary()
    finally:
        ranks.kill()
    assert rcs == [0, 0], ranks.stderr(0)[-2000:]
    assert served and not failures, failures[:3]
    assert summary["error_requests"] == 0 and summary["ok_requests"] >= len(served)


def test_sigterm_to_every_rank_still_drains(tmp_path):
    ranks = Ranks(tmp_path, 4, FLAGS + ["--mesh_shape", "1,2,2", "--sharding_rules", "model"])
    try:
        assert ranks.client.infer(np.zeros((2,) + SHAPE, np.float32)).shape == (2, 10)
        for rank in (3, 2, 1):  # the followers first: they keep serving
            ranks.signal(rank)
        time.sleep(0.5)
        assert ranks.client.infer(np.zeros((5,) + SHAPE, np.float32)).shape == (5, 10)
        rcs = ranks.stop()
    finally:
        ranks.kill()
    assert rcs == [0] * 4, [ranks.stderr(r)[-1000:] for r in range(4)]
    assert "serving until the front stops" in ranks.stderr(1)


def test_a_killed_follower_fails_the_front(tmp_path):
    ranks = Ranks(tmp_path, 2, FLAGS + ["--data_parallel"])
    try:
        x = np.zeros((3,) + SHAPE, np.float32)
        assert ranks.client.infer(x).shape == (3, 10)
        ranks.signal(1, signal.SIGKILL)
        ranks.procs[1].wait(timeout=30)
        t0 = time.monotonic()
        try:
            ranks.client.infer(x)
            raise AssertionError("a request succeeded after a rank died")
        except RuntimeError as e:
            assert "500" in str(e), e
        status, health = ranks.client.healthz()
        assert status == 503 and "fanout_fault" in health, health
        rcs = ranks.wait(timeout=TIMEOUT_S + 30)
        elapsed = time.monotonic() - t0
    finally:
        ranks.kill()
    assert rcs[0] == 1, ranks.stderr(0)[-2000:]
    assert elapsed < TIMEOUT_S, elapsed


def test_front_and_follower_load_no_jax(tmp_path):
    ranks = Ranks(tmp_path, 2, FLAGS + ["--data_parallel"])
    try:
        assert ranks.client.infer(np.zeros((1,) + SHAPE, np.float32)).shape == (1, 10)
        rcs = ranks.stop()
    finally:
        ranks.kill()
    assert rcs == [0, 0]
    for rank in (0, 1):
        loaded = set(ranks.modules(rank))
        assert "dwt_tpu_torch" in loaded and "torch" in loaded
        assert not loaded & {"jax", "jaxlib", "flax", "dwt_tpu"}, (rank, loaded)
