"""Ranks of the port's serving fan-out for the tests: ``python -m dwt_tpu_torch.serve.server`` per rank.

:class:`Ranks` starts ``world`` server processes on the CPU with
``--distributed --device cpu`` and the DWT_* variables (gloo over
localhost, two torch threads each, ``DWT_DIST_TIMEOUT_S`` short), reads
the front's ``serve_ready`` line and gives an HTTP client of it.  Each
rank runs through a wrapper that, at exit, writes the top-level packages
it loaded to ``modules_<rank>.json`` (the follower and the front must load
no ``jax`` and no ``dwt_tpu``).  Imports the port only.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dwt_tpu_torch.serve.server import HttpServeClient  # noqa: E402

TIMEOUT_S = 20  # DWT_DIST_TIMEOUT_S of the ranks

WRAPPER = """\
import atexit, json, runpy, sys
out = sys.argv[1]
def dump():
    with open(out, "w") as f:
        json.dump(sorted({m.split(".")[0] for m in sys.modules}), f)
atexit.register(dump)
sys.argv = ["dwt_tpu_torch.serve.server"] + sys.argv[2:]
runpy.run_module("dwt_tpu_torch.serve.server", run_name="__main__", alter_sys=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` serving ranks with ``flags``; ``client`` talks to the
    front, ``ready`` is its ``serve_ready`` record."""

    def __init__(self, tmp, world: int, flags: List[str], timeout: float = 120.0):
        self.tmp = tmp
        self.world = world
        port = free_port()
        env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
        env.update(DWT_DIST_TIMEOUT_S=str(TIMEOUT_S), OMP_NUM_THREADS="2",
                   DWT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   DWT_NUM_PROCESSES=str(world), PYTHONPATH=REPO)
        self.procs: List[subprocess.Popen] = []
        self.logs = []
        for rank in range(world):
            log = open(tmp / f"rank_{rank}.err", "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", WRAPPER, str(tmp / f"modules_{rank}.json"),
                 "--device", "cpu", "--distributed", "--port", "0", *flags],
                env={**env, "DWT_PROCESS_ID": str(rank)}, cwd=REPO,
                stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
                stderr=log, text=True))
        deadline = time.monotonic() + timeout
        line = ""
        while not line and time.monotonic() < deadline:
            line = self.procs[0].stdout.readline()
            if not line and self.procs[0].poll() is not None:
                break
        if not line:
            self.kill()
            raise AssertionError(f"the front never became ready: {self.stderr(0)[-3000:]}")
        self.ready = json.loads(line)
        self.client = HttpServeClient("127.0.0.1", self.ready["port"], timeout=60.0)

    def stderr(self, rank: int) -> str:
        with open(self.tmp / f"rank_{rank}.err") as f:
            return f.read()

    def fanout(self, **query) -> dict:
        q = "&".join(f"{k}=1" for k, v in query.items() if v)
        status, body = self.client.request("GET", "/fanout" + (f"?{q}" if q else ""))
        assert status == 200, body
        return body

    def signal(self, rank: int, sig=signal.SIGTERM) -> None:
        self.procs[rank].send_signal(sig)

    def wait(self, timeout: float = 60.0) -> List[Optional[int]]:
        """Every rank's exit code (None: still running at ``timeout``)."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        return [p.poll() for p in self.procs]

    def summary(self) -> Optional[dict]:
        """The front's ``serve_summary`` record (after its exit)."""
        for line in self.procs[0].stdout.read().splitlines():
            rec = json.loads(line)
            if rec.get("kind") == "serve_summary":
                return rec
        return None

    def modules(self, rank: int) -> List[str]:
        with open(self.tmp / f"modules_{rank}.json") as f:
            return json.load(f)

    def stop(self) -> List[Optional[int]]:
        """SIGTERM to the front; every rank's exit code."""
        self.client.close()
        self.signal(0)
        return self.wait()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()
