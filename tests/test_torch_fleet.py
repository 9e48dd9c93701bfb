"""Port deployment plane against the JAX package: watch → canary → swap → monitor → rollback.

Each package serves LeNet-DWT with the same randomized weights from its
own checkpoint directory, in its own format, and is handed the same
candidate sequence under fake clocks: a good checkpoint, one with NaN
weights (digest-valid), and one that goes live and then serves errors.
The ``reload``/``canary``/``swap``/``rollback`` events must agree in kind,
verdict and reason (version digests differ between the packages: the
port hashes named parameters, JAX tree paths).  Also covered: the
watcher's validity and dedup rules, delta-format candidates of both
packages, and the hot-swap contract — a swap under load sheds and fails
nothing, every batch is single-version, and every batch's logits equal
one generation's eval forward bitwise, with generations swapped and
built concurrently with dispatch.
"""

from __future__ import annotations

import io
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dwt_tpu.ckpt import store as jax_store
from dwt_tpu.fleet import CanaryGate as JaxCanaryGate
from dwt_tpu.fleet import HotReloader as JaxHotReloader
from dwt_tpu.fleet import PostSwapMonitor as JaxPostSwapMonitor
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.serve import AccessLog as JaxAccessLog
from dwt_tpu.serve import ServeEngine as JaxServeEngine
from dwt_tpu.train import create_train_state
from dwt_tpu.utils import checkpoint as jax_ckpt
from dwt_tpu_torch.ckpt import store
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.fleet import CanaryGate, HotReloader, PostSwapMonitor
from dwt_tpu_torch.fleet.watcher import CheckpointWatcher, newest_candidate
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.serve import AccessLog, ServeClient, ServeEngine
from dwt_tpu_torch.serve.engine import Version
from dwt_tpu_torch.serve.server import HttpServeClient
from dwt_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (28, 28, 1)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _randomize(params, stats, rng):
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.1, a.shape) if a.ndim == 1 else a
                   ).astype(np.float32), params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return np.asarray(a)

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def tied():
    """``(jax model, jax TrainState, params, stats)``: the randomized
    weights every checkpoint of this file perturbs."""
    model = JaxLeNetDWT(group_size=4)
    sample = jnp.zeros((2, 2) + SHAPE, jnp.float32)
    state = create_train_state(model, jax.random.key(0), sample, optax.identity())
    params, stats = _randomize(jax.device_get(state.params),
                               jax.device_get(state.batch_stats),
                               np.random.default_rng(0))
    return model, state.replace(params=params, batch_stats=stats), params, stats


def _perturbed(params, perturb):
    return jax.tree.map(lambda a: np.asarray(a) + np.float32(perturb), params)


def _port_model(params, stats):
    port = LeNetDWT(group_size=4)
    load_jax_variables(port, params, stats)
    return port


def _port_host(params, stats, step):
    port = _port_model(params, stats)
    return ckpt.HostState({"model": {k: v.clone() for k, v in port.state_dict().items()},
                           "optimizer": {"state": {}, "param_groups": []},
                           "step": step, "lr_scale": 1.0},
                          tuple(n for n, _ in port.named_parameters()))


def _save_port(d, params, stats, step, perturb=0.0, delta=False):
    host = _port_host(_perturbed(params, perturb), stats, step)
    if delta:
        return store.save_delta(d, step, host)
    return ckpt.save_state(d, step, host)


def _save_port_nan(d, params, stats, step):
    """A digest-valid port checkpoint with NaN weights (``save_state``
    refuses those, as it should)."""
    host = _port_host(jax.tree.map(lambda a: np.full_like(a, np.nan), params), stats, step)
    weights = host.payload["model"]
    root = os.path.abspath(d)
    tmp = os.path.join(root, ".tmp-nan")
    os.makedirs(tmp)
    torch.save(host.payload, os.path.join(tmp, ckpt.STATE_FILE))
    ckpt._write_manifest(tmp, step, ckpt.params_digest(
        (n, weights[n]) for n in host.param_names), {"format": ckpt.TORCH_FORMAT})
    os.replace(tmp, os.path.join(root, str(step)))


def _save_jax(d, state, step, perturb=0.0):
    jax_ckpt.save_state(d, step, state.replace(
        step=step, params=_perturbed(state.params, perturb)))


def _save_jax_nan(d, state, step):
    import orbax.checkpoint as ocp

    nan_params = jax.tree.map(lambda a: np.full_like(np.asarray(a), np.nan), state.params)
    tree = {"step": np.int64(step), "params": nan_params,
            "batch_stats": jax.device_get(state.batch_stats)}
    root = os.path.abspath(d)
    tmp = os.path.join(root, ".tmp-nan")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(tmp, jax.device_get(tree))
    jax_ckpt._write_manifest(tmp, step, jax_ckpt.params_digest(nan_params))
    os.replace(tmp, os.path.join(root, str(step)))


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n,) + SHAPE).astype(np.float32)


def _story(side_events):
    keep = ("kind", "ok", "reason", "step")
    return [{k: e[k] for k in keep if k in e} for e in side_events]


def _run_candidate_story(pkg, d, tied):
    """The shared candidate sequence through one package's reloader;
    returns its lifecycle events."""
    model, state, params, stats = tied
    port = pkg == "port"
    buf = io.StringIO()
    clock = _FakeClock()
    if port:
        _save_port(d, params, stats, 1)
        engine = ServeEngine.from_checkpoint(d, LeNetDWT(group_size=4), SHAPE,
                                             buckets=(8,), device="cpu")
        alog, mon_cls, gate_cls, rel_cls = AccessLog(stream=buf), PostSwapMonitor, \
            CanaryGate, HotReloader
    else:
        _save_jax(d, state, 1)
        engine = JaxServeEngine.from_checkpoint(d, model, SHAPE, buckets=(8,))
        alog, mon_cls, gate_cls, rel_cls = JaxAccessLog(stream=buf), JaxPostSwapMonitor, \
            JaxCanaryGate, JaxHotReloader
    x = _images(8, 4)
    monitor = mon_cls(alog, error_rate_threshold=0.2, min_requests=8,
                      decide_after_s=30.0, clock=clock)
    reloader = rel_cls(engine, d, access_log=alog, monitor=monitor,
                       canary=gate_cls(engine, x))
    v1 = engine.version.label
    reloader.step()  # the boot version is primed: nothing to do
    save, save_nan = ((lambda s, p: _save_port(d, params, stats, s, p)),
                      (lambda s: _save_port_nan(d, params, stats, s))) if port else \
        ((lambda s, p: _save_jax(d, state, s, p)), (lambda s: _save_jax_nan(d, state, s)))
    save(2, 0.01)
    reloader.step()                              # reload → canary ok → swap
    v2 = engine.version.label
    assert v2 != v1 and engine.version.step == 2
    for _ in range(8):
        alog.record("ok", 1, version=v2, e2e_ms=5.0)
    reloader.step()                              # verdict ok: v2 holds
    assert not monitor.armed
    save_nan(3)
    reloader.step()                              # reload → canary refuses
    assert engine.version.label == v2 and len(reloader.rejected) == 1
    assert "non-finite" in next(iter(reloader.rejected.values()))
    save(4, 0.02)
    reloader.step()                              # reload → canary ok → swap
    v4 = engine.version.label
    assert v4 not in (v1, v2)
    for _ in range(8):
        alog.record("error", 1, version=v4, error="boom")
    reloader.step()                              # rollback to v2
    assert engine.version.label == v2 and reloader.rollback_count == 1
    reloader.step()                              # v4 blacklisted: no redeploy
    assert reloader.swap_count == 2
    np.testing.assert_array_equal(engine.infer(x), engine.infer(x))
    return [json.loads(l) for l in buf.getvalue().splitlines() if '"access"' not in l]


def test_candidate_sequence_gives_jaxs_events(tmp_path, tied):
    ours = _run_candidate_story("port", str(tmp_path / "port"), tied)
    ref = _run_candidate_story("jax", str(tmp_path / "jax"), tied)
    assert _story(ours) == _story(ref)
    # The refusal is two canary records: the gate's verdict and the
    # reloader's refusal of the candidate.
    assert [e["kind"] for e in ours] == [
        "reload", "canary", "swap", "reload", "canary", "canary", "reload", "canary",
        "swap", "rollback"]


def test_watcher_sees_only_valid_finalized_steps(tmp_path, tied):
    _, _, params, stats = tied
    d = str(tmp_path / "ck")
    assert newest_candidate(d) is None
    _save_port(d, params, stats, 3)
    cand = newest_candidate(d)
    assert (cand.step, cand.source) == (3, "checkpoint") and len(cand.digest) == 64
    os.makedirs(os.path.join(d, ".tmp-9"))           # unfinalized: invisible
    assert newest_candidate(d).step == 3
    os.makedirs(os.path.join(d, "7"))                # torn: skipped
    with open(os.path.join(d, "7", "manifest.json"), "w") as f:
        json.dump({"step": 7, "params_digest": "x", "format": "torch_full",
                   "files": {"gone.bin": 123}}, f)
    assert newest_candidate(d).step == 3
    w = CheckpointWatcher(d, poll_s=0.01)
    first = w.poll_once()
    assert first.step == 3 and w.poll_once() is None  # dedup on (step, digest)
    _save_port(d, params, stats, 5, perturb=0.01)
    nxt = w.poll_once()
    assert nxt.step == 5 and nxt.digest != first.digest


def test_watcher_holds_an_older_step_while_the_newest_is_resaved(tmp_path, tied):
    """A same-step re-save moves the finalized step aside for a moment
    (``_finalize_rename``): a poll in that window sees the step before it
    as the newest.  The watcher emits an older step only when two polls in
    a row see it newest, so a re-save never redeploys the step before it,
    while a step that is really gone is still rolled back to."""
    _, _, params, stats = tied
    d = str(tmp_path / "ck")
    _save_port(d, params, stats, 3)
    _save_port(d, params, stats, 6, perturb=0.01)
    w = CheckpointWatcher(d, poll_s=0.01)
    assert w.poll_once().step == 6
    # The window inside _finalize_rename: step 6 aside, the new one not yet in.
    final, aside = os.path.join(d, "6"), os.path.join(d, ".tmp-replaced-6")
    os.replace(final, aside)
    assert newest_candidate(d).step == 3 and w.poll_once() is None
    os.replace(aside, final)
    assert w.poll_once() is None
    _save_port(d, params, stats, 6, perturb=0.01)  # the whole re-save
    assert w.poll_once() is None
    # Step 6 deleted: the next two polls see 3, the second emits it.
    shutil.rmtree(final)
    assert w.poll_once() is None
    back = w.poll_once()
    assert back.step == 3 and w.poll_once() is None
    # A newer step is emitted on its first poll, as before.
    _save_port(d, params, stats, 9, perturb=0.02)
    assert w.poll_once().step == 9


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_delta_candidates_deploy_like_full_ones(tmp_path, tied, writer):
    """A delta-format step (the port's, or the JAX package's cas_delta) is
    a candidate once its chain validates, and it deploys the weights a
    full checkpoint of the same state serves, bitwise."""
    model, state, params, stats = tied
    d = str(tmp_path / "delta")
    if writer == "port":
        _save_port(d, params, stats, 1, delta=True)
    else:
        jax_store.save_delta(d, 1, jax_ckpt.host_fetch(state.replace(step=1)))
    engine = ServeEngine.from_checkpoint(d, LeNetDWT(group_size=4), SHAPE,
                                         buckets=(8,), device="cpu")
    reloader = HotReloader(engine, d, access_log=AccessLog(),
                           canary=CanaryGate(engine, _images(8, 1)))
    if writer == "port":
        _save_port(d, params, stats, 2, perturb=0.01, delta=True)
    else:
        moved = state.replace(step=2, params=_perturbed(state.params, 0.01))
        jax_store.save_delta(d, 2, jax_ckpt.host_fetch(moved))
    assert json.load(open(os.path.join(d, "2", "manifest.json")))["mode"] == "delta"
    cand = newest_candidate(d)
    assert cand.step == 2 and cand.digest
    reloader.step()
    assert reloader.swap_count == 1 and engine.version == Version(2, cand.digest)
    full = ServeEngine(_port_model(_perturbed(params, 0.01), stats), SHAPE,
                       buckets=(8,), device="cpu")
    x = _images(8, 2)
    np.testing.assert_array_equal(engine.infer(x), full.infer(x))


def test_same_checkpoint_swap_is_a_bitwise_noop(tmp_path, tied):
    _, _, params, stats = tied
    d = str(tmp_path / "ck")
    _save_port(d, params, stats, 1)
    engine = ServeEngine.from_checkpoint(d, LeNetDWT(group_size=4), SHAPE,
                                         buckets=(1, 8), device="cpu")
    x = _images(5, 5)
    before = engine.infer(x)
    cand = newest_candidate(d)
    assert engine.version == Version(1, cand.digest)
    payload, digest = ckpt.read_payload(cand.path)
    for st in (engine.build_state_from_checkpoint(cand.path),
               engine.build_state_from_tree(payload, digest=digest)):
        prev = engine.swap(st)
        np.testing.assert_array_equal(engine.infer(x), before)
        engine.swap(prev)
    with pytest.raises(ValueError, match="candidate"):
        engine.build_state_from_tree({"model": {"conv1.weight": torch.zeros(1)}},
                                     digest=digest)
    # The checkpoint path loads through the same checks: a payload whose
    # parameters do not hash to its manifest's digest is refused.
    payload["model"]["conv1.weight"] = payload["model"]["conv1.weight"] + 1
    with pytest.raises(ValueError, match="digest"):
        engine.build_state_from_tree(payload, digest=digest)


def test_concurrent_swaps_never_tear_a_batch(tied):
    """Generations are swapped and built on other threads while the
    dispatcher serves: no request sheds or fails, every batch carries one
    version, both versions serve, and every batch's logits equal that
    generation's eval forward of the same padded batch, bitwise."""
    _, _, params, stats = tied
    engine = ServeEngine(_port_model(params, stats), SHAPE, buckets=(1, 4, 8),
                         device="cpu", step=1, digest="a" * 64)
    gen_a = engine.state
    gen_b = engine.build_state(_port_model(_perturbed(params, 0.05), stats),
                               version=Version(2, "b" * 64))
    gens = {gen_a.version.label: gen_a, gen_b.version.label: gen_b}
    batches = []
    forward = engine.forward

    def recording_forward(x, bucket, state=None):
        out = forward(x, bucket, state=state)
        batches.append((state.version.label, x.clone(), bucket, out.clone()))
        return out

    engine.forward = recording_forward
    access = AccessLog()
    client = ServeClient(engine, max_batch_delay_ms=1.0, access_log=access)
    stop = threading.Event()

    def swapper():
        rng = random.Random(0)
        while not stop.is_set():
            engine.swap(gens[rng.choice(sorted(gens))])
            # Builds on this thread too: a new generation is its own module.
            engine.build_state_from_stats(
                gen_a, {k: v.numpy() * 1.01 for k, v in gen_a.batch_stats.items()},
                version=Version(3, "c" * 64))
            time.sleep(0.0005)

    xs = [_images(k, 20 + k) for k in (1, 2, 3, 4, 1, 2)]
    t = threading.Thread(target=swapper)
    t.start()
    try:
        futures = [(x, client.submit(x)) for x in (xs[i % len(xs)] for i in range(90))]
        results = [(x, f, f.result(timeout=60)) for x, f in futures]
    finally:
        stop.set()
        t.join(30)
        client.close()
        engine.forward = forward
        engine.swap(gen_a)
    assert access.shed_requests == 0 and access.error_requests == 0
    assert {label for label, *_ in batches} == set(gens)
    for label, x, bucket, out in batches:
        np.testing.assert_array_equal(
            out.numpy(), forward(x, bucket, state=gens[label]).numpy())
    for x, f, logits in results:
        want = forward(engine.stage(np.concatenate(
            [x, np.repeat(x[-1:], 8 - len(x), 0)])), 8, state=gens[f.version]).numpy()
        assert f.version in gens and logits.shape == (len(x), 10)
        np.testing.assert_allclose(logits, want[:len(x)], rtol=1e-5, atol=1e-5)


def test_mid_load_swap_records_one_version_per_batch(tied):
    _, _, params, stats = tied
    engine = ServeEngine(_port_model(params, stats), SHAPE, buckets=(1, 4, 8),
                         device="cpu", step=1, digest="a" * 64)
    records = []
    access = AccessLog()
    original = access.record

    def tee(status, n, **fields):
        records.append({"status": status, **fields})
        original(status, n, **fields)

    access.record = tee
    client = ServeClient(engine, max_batch_delay_ms=1.0, access_log=access)
    old = engine.version.label
    xs = [_images(k, k) for k in (1, 2, 3, 1, 2, 1, 4, 2)]
    try:
        futures = []
        for i in range(80):
            futures.append(client.submit(xs[i % len(xs)]))
            if i == 30:
                engine.swap(engine.build_state(
                    _port_model(_perturbed(params, 0.01), stats),
                    version=Version(999, "f" * 64)))
            time.sleep(0.001)
        for f in futures:
            assert f.result(timeout=60) is not None
    finally:
        client.close()
    oks = [r for r in records if r["status"] == "ok"]
    assert len(oks) == 80 and access.shed_requests == 0 == access.error_requests
    by_batch = {}
    for r in oks:
        by_batch.setdefault(r["batch_seq"], set()).add(r["version"])
    assert all(len(v) == 1 for v in by_batch.values())
    assert {old, "999-ffffffff"} <= set().union(*by_batch.values())


def test_serve_watch_hot_reload_over_http(tmp_path, tied):
    """The server process with ``--watch``: a checkpoint written while it
    serves passes the canary and goes live, every reply succeeds and names
    one version, ``/healthz`` reports the new version, and SIGTERM drains
    to exit 0 with swap and access records in the log."""
    _, _, params, stats = tied
    d = str(tmp_path / "ck")
    _save_port(d, params, stats, 1)
    access = str(tmp_path / "access.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dwt_tpu_torch.serve.server", "--device", "cpu",
         "--ckpt_dir", d, "--model", "lenet", "--buckets", "1,4",
         "--max_batch_delay_ms", "2", "--port", "0", "--watch",
         "--reload_poll_s", "0.2", "--access_log", access],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    client = None
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["kind"] == "serve_ready" and ready["watch"]
        v1 = ready["version"]
        client = HttpServeClient("127.0.0.1", ready["port"], timeout=30.0)
        x = np.zeros((1,) + SHAPE, np.float32)
        assert client.infer_reply(x)["version"] == v1
        _save_port(d, params, stats, 2, perturb=0.01)
        deadline = time.monotonic() + 60
        v2 = v1
        while time.monotonic() < deadline and v2 == v1:
            reply = client.infer_reply(x)
            assert reply["version"] in (v1, v2) or reply["version"].startswith("2-")
            status, health = client.healthz()
            assert status == 200
            v2 = health["version"]
            time.sleep(0.2)
        assert v2 != v1 and v2.startswith("2-")
        assert client.infer_reply(x)["version"] == v2
        stats_body = client.stats()
        assert stats_body["version"] == v2 and stats_body["swap_count"] >= 1
    finally:
        if client is not None:
            client.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    assert rc == 0, proc.stderr.read()[-2000:]
    kinds = [json.loads(line)["kind"] for line in open(access)]
    assert {"reload", "canary", "swap", "access"} <= set(kinds)


@pytest.mark.parametrize("flag,world,jax_flags", [
    (["--sharding_rules", "model"], 8, dict(sharding_rules="model")),
    (["--mesh_shape", "1,1,1"], 1, dict(mesh_shape="1,1,1")),
    (["--data_parallel"], 8, dict(data_parallel=True)),
])
def test_fanout_flags_resolve_to_the_jax_plan(flag, world, jax_flags):
    """The server's three fan-out flags resolve, at a group of ``world``
    ranks, to the plan JAX's ``plan_from_flags`` gives on as many devices
    (the conftest's 8; ``--mesh_shape 1,1,1`` needs one device whatever
    the count, and the port's mesh must cover every rank)."""
    from dwt_tpu import parallel as jpar
    from dwt_tpu_torch.serve import server

    args = server.build_parser().parse_args(["--init_random", "--device", "cpu"] + flag)
    port = server.build_plan(args, world_size=world)
    want = jpar.plan_from_flags(**jax_flags)
    assert port.mode == want.mode
    assert dict(port.mesh.shape) == dict(want.mesh.shape)
    assert port.data_size == want.data_size
    assert port.rules == [(pat, tuple(spec)) for pat, spec in want.rules]
