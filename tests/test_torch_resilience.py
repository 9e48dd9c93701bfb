"""The port's resilience plane on the CPU, held to the JAX package's.

* Fault plans: ``dwt_tpu_torch.resilience.inject.FaultPlan`` accepts and
  refuses what the JAX plan does for every ported kind, and refuses the
  kinds it does not port with the ROADMAP item that takes them.
* The guard, loop against loop: both digits loops under the same armed
  ``nan_at_step`` plan (the JAX loop at ``harvest_depth=0``, the port's
  guard mode) give the same guard and rollback records, the same batch
  ids after a rollback, and train losses within ``LOSS_TOL`` (the two
  frameworks' convolutions sum in other orders), from weights tied
  through the bridge; ``halt`` raises ``DivergenceError`` in both.
* The backoff scale: a step at ``lr · s`` moves every parameter by ``s``
  times the step at ``lr`` (SGD and coupled-L2 Adam), the optimizer's
  buffers unchanged — the JAX package's ``scale_by_backoff``.
* The background writer: an async digits run equals its synchronous twin
  bitwise (records, parameters, the state files and their manifests'
  digests), and a writer error surfaces on the next save or flush.
* The guard's snapshot keeps strides, reverts in place and clears the
  eval cache; preemption, the notice (file and a local HTTP metadata
  server), the watchdog and the boundary's decisions, unit by unit.
"""

from __future__ import annotations

import http.server
import io
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.data import loader as jax_loader
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.resilience import inject as jax_inject
from dwt_tpu.resilience.guard import DivergenceError as JaxDivergenceError
from dwt_tpu.train import loop as jax_loop
from dwt_tpu.utils.metrics import MetricLogger
from dwt_tpu_torch.config import DigitsConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data import loader
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.nn.norms import whitening_sites
from dwt_tpu_torch.resilience import (
    AsyncCheckpointer,
    DivergenceError,
    DivergenceGuard,
    HangWatchdog,
    NoticeWatcher,
    PreemptionHandler,
    inject,
    notice,
)
from dwt_tpu_torch.resilience.coord import (
    EVENT_HALT,
    EVENT_RECOVERED,
    EVENT_ROLLBACK,
    Coordinator,
    assert_not_writer_thread,
)
from dwt_tpu_torch.train import loop
from dwt_tpu_torch.train.optim import adam_l2, sgd_two_group, set_learning_rates
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.utils import checkpoint as ckpt

LOSS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six test processes on the
    box's cores, and small models gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()
    jax_inject.disarm()


# ------------------------------------------------------------- fault plans

PLAN_SPECS = [
    {"nan_at_step": 3},
    {"nan_at_step": [3, 5]},
    {"nan_at_step": [3, 3]},
    {"nan_at_step": "three"},
    {"nan_at_step": True},
    {"nan_at_step": 0},
    {"hang_at_step": 4, "sigterm_at_step": 9},
    {"notice_at_step": 6, "sigterm_at_step": 6},
    {"notice_at_step": 4, "sigterm_at_step": 6, "slow_step_at": 2, "slow_step_s": 0.5},
    {"slow_step_s": 2.0},
    {"slow_step_at": 2, "slow_step_s": -1},
    {"io_error_saves": 2},
    {"io_error_saves": -1},
    {"crash_in_save": True},
    {"crash_in_save": "yes"},
    {"crash_in_save": 0},
    {"corrupt_items": {"source": [3], "target": 1}},
    {"corrupt_items": {"eval": [1]}},
    {"corrupt_items": [1, 2]},
    {"dead_worker_at": {"source": [2]}},
    {"slow_item_at": {"target": [0]}, "slow_item_s": 0.2},
    {"slow_item_s": 0.2},
    {"kill_mid_delta_promote": 8},
    {"kill_mid_delta_promote": 0},
    {"missing_parent_blob": 12},
    {"missing_parent_blob": True},
    {"hang_at_stp": 3},
    {"serve_poison_requests": [0, 3, 9]},
    {"serve_poison_requests": 4},
    {"serve_poison_requests": [-1]},
    {"serve_drift_shift": {"at_request": 2, "offset": 0.5, "scale": 1.5}},
    {"serve_drift_shift": {"offset": 1}},
    {"serve_drift_shift": {"scale": 1.0, "offset": 0.0}},
    {"serve_drift_shift": {"at_request": 1, "shift": 2.0}},
    {"serve_drift_shift": {"offset": float("inf")}},
    {"serve_drift_shift": [1, 2]},
]


def _outcome(build, spec):
    try:
        plan = build(spec)
    except ValueError as e:
        return "refused", str(e)
    return "accepted", {k: getattr(plan, k) for k in spec}


@pytest.mark.parametrize("spec", PLAN_SPECS, ids=lambda s: json.dumps(s))
def test_fault_plan_accepts_and_refuses_what_the_jax_plan_does(spec):
    ours = _outcome(inject.FaultPlan.from_spec, spec)
    ref = _outcome(jax_inject.FaultPlan.from_spec, spec)
    assert ours[0] == ref[0], (ours, ref)
    if ours[0] == "accepted":
        assert ours[1] == ref[1]


@pytest.mark.parametrize("kind,value,item", [
    ("kill_writer_mid_shard", 8, "item 8"),
    ("kill_supervisor_at_schedule", 1, "item 9"),
    ("sweep_preempt_pairs", ["Art2Clipart"], "item 9"),
    ("sweep_job_kill_mid_save", ["Art2Clipart"], "item 9"),
])
def test_fault_plan_refuses_the_kinds_it_does_not_port(kind, value, item):
    jax_inject.FaultPlan.from_spec({kind: value})  # a kind the JAX plan takes
    with pytest.raises(ValueError, match=f"not ported.*ROADMAP queue 1 {item}"):
        inject.FaultPlan.from_spec({kind: value})


def test_fault_plan_env_contract(monkeypatch):
    """``DWT_FAULT_PLAN``: read once, strict JSON, no duplicate kinds."""
    for raw, match in (('{"nan_at_step": 1, "nan_at_step": 2}', "duplicate fault kind"),
                       ("[1, 2]", "JSON object"), ("{not json", "not valid JSON")):
        monkeypatch.setenv(inject.ENV_VAR, raw)
        with pytest.raises(ValueError, match=match):
            inject.FaultPlan.from_env()
        with pytest.raises(ValueError, match=match):
            jax_inject.FaultPlan.from_env()
    monkeypatch.setenv(inject.ENV_VAR, '{"nan_at_step": [2, 4]}')
    inject._env_checked = False
    assert inject.current().nan_at_step == [2, 4]


# ------------------------------------------------- the guard, loop vs loop

DIGITS = dict(synthetic=True, synthetic_size=64, source_batch_size=16,
              target_batch_size=16, test_batch_size=32, log_interval=1,
              group_size=4, seed=1, ckpt_every_epochs=1)
GUARD_KINDS = ("divergence", "lr_backoff", "lr_recover", "skip_step", "rollback")


class _Records(MetricLogger):
    def __init__(self):
        super().__init__(stream=io.StringIO())
        self.records = []

    def log(self, kind, step, sync=False, flush=False, **values):
        self.records.append((kind, step, values))


def _jax_lenet_init():
    variables = jax.jit(lambda k: JaxLeNetDWT(group_size=4).init(
        k, jnp.zeros((2, 16, 28, 28, 1)), train=True))(jax.random.key(1))
    return load_jax_variables(LeNetDWT(group_size=4),
                              jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]))


def _recording(module, monkeypatch):
    ids = {}
    inner = module.batch_iterator

    def recording(*args, **kwargs):
        kwargs.pop("on_batch_ids", None)  # the JAX plane's trail hook (off)
        return inner(*args, on_batch_ids=ids.setdefault(
            kwargs.get("quarantine_key"), []).append, **kwargs)

    monkeypatch.setattr(module, "batch_iterator", recording)
    return ids


def _both_loops(tmp_path, monkeypatch, plan, flags):
    """``((records, ids, error), (ref records, ref ids, ref error))`` of the
    port's and the JAX digits loops under the same plan."""
    out = []
    for name in ("ours", "jax"):
        ids = _recording(loader if name == "ours" else jax_loader, monkeypatch)
        cfg_flags = {**DIGITS, **flags, "ckpt_dir": str(tmp_path / name)}
        error = None
        if name == "ours":
            inject.arm(inject.FaultPlan.from_spec(plan))
            records = []
            try:
                loop.run_digits(DigitsConfig(**cfg_flags, harvest_depth=0, device="cpu"),
                                lambda kind, step, **f: records.append((kind, step, f)),
                                model=_jax_lenet_init())
            except DivergenceError as e:
                error = e
        else:
            jax_inject.arm(jax_inject.FaultPlan.from_spec(plan))
            ref = _Records()
            try:
                jax_loop.run_digits(JaxDigitsConfig(**cfg_flags, harvest_depth=0), ref)
            except JaxDivergenceError as e:
                error = e
            records = ref.records
        out.append((records, {k: [tuple(int(i) for i in b) for b in v]
                              for k, v in ids.items()}, error))
    return out


GUARD_CASES = {
    # A single NaN reverted in memory; the data streams run on.
    "skip_step": ({"nan_at_step": 3}, dict(epochs=2, guard_policy="skip_step",
                                           guard_interval=1)),
    # A burst: each strike reverted again.
    "skip_step_burst": ({"nan_at_step": [3, 6]}, dict(epochs=2, guard_policy="skip_step",
                                                      guard_interval=1)),
    # The epoch-1 checkpoint restored, the streams reseeded.
    "rollback": ({"nan_at_step": 6}, dict(epochs=3, guard_policy="rollback",
                                          guard_interval=2)),
    # The first strike backs off in memory, the second escalates.
    "lr_backoff_then_rollback": ({"nan_at_step": [3, 5]}, dict(
        epochs=3, guard_policy="rollback", guard_interval=1, guard_lr_backoff=0.5,
        guard_backoff_recovery=2)),
    "halt": ({"nan_at_step": 3}, dict(epochs=2, guard_policy="halt", guard_interval=1)),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_ladder_matches_the_jax_loop(case, tmp_path, monkeypatch):
    plan, flags = GUARD_CASES[case]
    (ours, ids, err), (ref, ref_ids, ref_err) = _both_loops(
        tmp_path, monkeypatch, plan, flags)
    guard = [(k, s, f) for k, s, f in ours if k in GUARD_KINDS]
    assert guard == [(k, s, f) for k, s, f in ref if k in GUARD_KINDS]
    assert guard, "the plan fired no guard event"
    if case == "halt":
        assert isinstance(err, DivergenceError) and isinstance(ref_err, JaxDivergenceError)
        assert "non-finite" in str(err)
    else:
        assert err is None and ref_err is None
    if "rollback" in case:
        assert [f["source"] for k, _, f in guard if k == "rollback"] == ["checkpoint"]
    # The batches, before and after the recovery (a rollback reopens the
    # streams reseeded at the checkpoint's position).
    assert ids == ref_ids
    train = [(s, f) for k, s, f in ours if k == "train"]
    ref_train = [(s, f) for k, s, f in ref if k == "train"]
    assert [s for s, _ in train] == [s for s, _ in ref_train]
    for (s, a), (_, b) in zip(train, ref_train):
        for key in ("cls_loss", "entropy_loss"):
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_TOL, equal_nan=True,
                                       err_msg=f"{key} at step {s}")
    tests = [(s, f["accuracy"]) for k, s, f in ours if k == "test"]
    assert tests == [(s, f["accuracy"]) for k, s, f in ref if k == "test"]


def test_guard_lr_backoff_needs_a_policy():
    with pytest.raises(ValueError, match="needs an active guard"):
        loop._make_guard(DigitsConfig(guard_lr_backoff=0.5), None)
    with pytest.raises(ValueError, match="in \\(0, 1\\)"):
        DivergenceGuard("halt", 1, lr_backoff=1.5)
    with pytest.raises(ValueError, match="policy must be one of"):
        DivergenceGuard("none", 1)


# ----------------------------------------------------- the backoff scale


@pytest.mark.parametrize("make", [
    lambda m: sgd_two_group(m, momentum=0.9, weight_decay=5e-4, head_key="fc4"),
    lambda m: adam_l2(m, weight_decay=5e-4),
], ids=["sgd", "adam"])
def test_lr_scale_scales_the_final_update(make):
    """From one state and gradient (its second step, so that the momentum
    or the moments are not fresh), a step at ``lr · 0.5`` moves every
    parameter by half the move at ``lr``, and leaves the optimizer's
    buffers bitwise where the unscaled step leaves them: scaling the lr is
    optax's scaling of the final update."""
    torch.manual_seed(0)
    m_full, m_half = LeNetDWT(group_size=4), LeNetDWT(group_size=4)
    m_half.load_state_dict(m_full.state_dict())
    o_full, o_half = make(m_full), make(m_half)
    schedules = [lambda s: 1e-2] * len(o_full.param_groups)
    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen) for p in m_full.parameters()]
             for _ in range(2)]
    before = None
    for step, (g, scale) in enumerate(zip(grads, (1.0, 0.5))):
        if step == 1:
            before = [p.detach().clone() for p in m_full.parameters()]
        for m, opt, s in ((m_full, o_full, 1.0), (m_half, o_half, scale)):
            for p, gi in zip(m.parameters(), g):
                p.grad = gi.clone()
            set_learning_rates(opt, schedules, step, s)
            opt.step()
    # Each move is read back as a difference of f32 parameters, so it
    # carries the parameter's rounding (half an ulp of |p| ≤ 1: 6e-8).
    for p0, a, b in zip(before, m_full.parameters(), m_half.parameters()):
        torch.testing.assert_close(b.detach() - p0, 0.5 * (a.detach() - p0),
                                   rtol=1e-5, atol=6e-8)
    for pa, pb in zip(m_full.parameters(), m_half.parameters()):
        for key, value in o_full.state[pa].items():
            if torch.is_tensor(value):
                assert torch.equal(value, o_half.state[pb][key]), key


def test_lr_scale_is_saved_and_an_older_checkpoint_loads_as_one(tmp_path):
    model = LeNetDWT(group_size=4)
    state = TrainState(model, adam_l2(model), (lambda s: 1e-3,), step=3, lr_scale=0.5)
    payload = state.state_dict()
    assert payload["lr_scale"] == 0.5
    state.lr_scale = 0.25
    state.load_state_dict(payload)
    assert state.lr_scale == 0.5
    del payload["lr_scale"]  # a checkpoint written before the scale was saved
    state.load_state_dict(payload)
    assert state.lr_scale == 1.0


# ------------------------------------------------------ the guard's snapshot


def _trained_state():
    model = LeNetDWT(group_size=4).to(memory_format=torch.channels_last)
    opt = sgd_two_group(model, head_key="fc4")
    state = TrainState(model, opt, (lambda s: 1e-2, lambda s: 1e-3))
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    set_learning_rates(opt, state.schedules, 0)
    opt.step()
    state.step = 1
    return state


def test_guard_snapshot_keeps_strides_and_reverts_in_place():
    state = _trained_state()
    model, opt = state.model, state.optimizer
    guard = DivergenceGuard("skip_step", 1)
    guard.prime(state)
    snap = guard._good.payload
    w = model.conv1.weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert snap["model"]["conv1.weight"].stride() == w.stride()
    pointers = {n: p.data_ptr() for n, p in model.named_parameters()}
    buffers = {id(p): opt.state[p]["momentum_buffer"].data_ptr() for p in model.parameters()}
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    for site in whitening_sites(model).values():
        site.eval_matrix = torch.ones(1)
    # Poison, then a failed check: the skip_step rung reverts in place.
    inject.arm(inject.FaultPlan(nan_at_step=2))
    metrics = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(1.0)}
    state, metrics = inject.maybe_nan(state, metrics, 2)
    assert torch.isnan(w).all() and torch.isnan(metrics["loss"])
    state.step = 2
    guard.step(state, metrics, 1, 2)
    assert state.step == 1 and guard.recoveries == 1 and guard.checks == 1
    for n, p in model.named_parameters():
        assert p.data_ptr() == pointers[n] and torch.equal(p.detach(), want[n]), n
        assert opt.state[p]["momentum_buffer"].data_ptr() == buffers[id(p)]
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert all(site.eval_matrix is None for site in whitening_sites(model).values())


def test_guard_checks_once_per_interval():
    state = _trained_state()
    guard = DivergenceGuard("halt", 5)
    metrics = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(2.0)}
    for s in range(1, 21):
        guard.step(state, metrics, 1, s)
    assert guard.checks == 4
    with pytest.raises(DivergenceError, match="policy=halt"):
        for s in range(21, 26):
            guard.step(state, {"loss": torch.tensor(float("nan")),
                               "grad_norm": torch.tensor(1.0)}, 1, s)


# ---------------------------------------------------- async against sync


def _digits_run(tmp_path, name, **flags):
    records = []
    cfg = DigitsConfig(**{**DIGITS, "epochs": 2, **flags},
                       ckpt_dir=str(tmp_path / name), device="cpu")
    loop.run_digits(cfg, lambda kind, step, **f: records.append((kind, step, f)),
                    model=_jax_lenet_init())
    return records


def test_async_saves_equal_sync_saves_bitwise(tmp_path):
    a = _digits_run(tmp_path, "async")
    s = _digits_run(tmp_path, "sync", async_ckpt=False)
    timing = ("seconds", "writer_s", "eval_s", "eval_imgs_per_s", "dispatch_ms_p50",
              "dispatch_ms_p99", "sync", "dir")

    def strip(recs):
        return [(k, st, {n: v for n, v in f.items() if n not in timing}) for k, st, f in recs]

    assert sorted(strip(a), key=str) == sorted(strip(s), key=str)
    saves = [(st, f["sync"]) for k, st, f in a if k == "checkpoint"]
    assert saves == [(4, False), (8, False)]
    assert [f["sync"] for k, _, f in s if k == "checkpoint"] == [True, True]
    for step in (4, 8):
        pa, ps = (tmp_path / d / str(step) for d in ("async", "sync"))
        assert (pa / "state.pt").read_bytes() == (ps / "state.pt").read_bytes()
        ma, ms = (json.loads((p / "manifest.json").read_text()) for p in (pa, ps))
        assert ma["params_digest"] == ms["params_digest"] and ma["files"] == ms["files"]


def test_writer_error_surfaces_on_the_next_save_and_flush(tmp_path):
    state = _trained_state()
    acp = AsyncCheckpointer()
    inject.arm(inject.FaultPlan(io_error_saves=99))
    acp.save(str(tmp_path / "ck"), 1, state)
    with pytest.raises(OSError, match="injected I/O error"):
        acp.save(str(tmp_path / "ck"), 2, state)  # the first save's error
    inject.disarm()
    acp.save(str(tmp_path / "ck"), 3, state)
    assert acp.flush().endswith("3") and ckpt.valid_steps(str(tmp_path / "ck")) == [3]
    inject.arm(inject.FaultPlan(io_error_saves=99))
    acp.save(str(tmp_path / "ck"), 4, state)
    with pytest.raises(OSError, match="injected I/O error"):
        acp.flush()
    acp.close()  # the error was raised once; the pipeline stays usable


def test_writer_thread_refuses_compute_stream_work():
    """The guard's and the checkpoint's snapshots launch copies on the
    compute stream: a checkpoint writer thread may take neither."""
    from dwt_tpu_torch.resilience import snapshot_state

    state = _trained_state()
    errors = []

    def run():
        for take in (lambda: DivergenceGuard("skip_step", 1).prime(state),
                     lambda: snapshot_state(state)):
            try:
                take()
            except RuntimeError as e:
                errors.append(str(e))

    t = threading.Thread(target=run, name="dwt-ckpt-writer-7")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(errors) == 2
    assert all("writer thread" in e for e in errors)
    assert_not_writer_thread("a snapshot")  # the loop's own thread may


# ------------------------------------- preemption, notice, watchdog, coord


def test_preemption_handler_flags_and_a_second_sigint_interrupts():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        assert not h.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop and h.signum == signal.SIGTERM
        with pytest.raises(KeyboardInterrupt):
            h._handle(signal.SIGINT, None)  # the operator's second Ctrl-C
    assert signal.getsignal(signal.SIGTERM) == before


def test_notice_watcher_file_and_metadata_sources(tmp_path, monkeypatch):
    path = str(tmp_path / "notice")
    with NoticeWatcher(file_path=path, poll_s=0.1) as nw:
        assert not nw.noticed
        notice.post_notice(path)
        for _ in range(100):
            if nw.noticed:
                break
            threading.Event().wait(0.05)
        assert nw.noticed

    body = {"value": b"FALSE"}

    class Metadata(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            assert self.headers["Metadata-Flavor"] == "Google"
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body["value"])

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Metadata)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv(notice.METADATA_URL_ENV,
                           f"http://127.0.0.1:{server.server_port}/preempted")
        assert NoticeWatcher().metadata_url is None  # off unless asked for
        nw = NoticeWatcher(metadata=True, poll_s=0.1)
        assert nw.metadata_url.startswith("http://127.0.0.1")
        assert not nw._check_once()
        body["value"] = b"TRUE"
        assert nw._check_once()
    finally:
        server.shutdown()
    inject.arm(inject.FaultPlan(notice_at_step=2))
    inject.at_step(2)
    assert NoticeWatcher().noticed
    inject.disarm()
    assert not NoticeWatcher().noticed


def test_watchdog_fires_dumps_and_keeps_the_newest(tmp_path):
    fired = []
    wd_dir = tmp_path / "watchdog"
    wd_dir.mkdir()
    for i in range(4):
        (wd_dir / f"stacks-1-{i}.txt").write_text("old")
        os.utime(wd_dir / f"stacks-1-{i}.txt", (i, i))
    wd = HangWatchdog(0.2, str(tmp_path), keep=3, _exit=fired.append)
    with wd:
        with wd.suspended():
            threading.Event().wait(0.6)  # masked: no fire
        assert not fired
        for _ in range(60):
            if fired:
                break
            threading.Event().wait(0.05)
    assert fired == [113] and wd.fired
    dumps = sorted(os.listdir(wd_dir))
    assert len(dumps) == 3 and "stacks-1-3.txt" in dumps
    assert "hang watchdog" in open(wd.stacks_path).read()


def test_coordinator_combines_flags_by_the_jax_rules():
    c = Coordinator()
    assert not c.enabled
    d = c.decide(stop=[False, True], event=[EVENT_RECOVERED, EVENT_HALT, EVENT_ROLLBACK],
                 rollback_step=[-1, 7, 5], notice=[False, True])
    assert (d.stop, d.event, d.rollback_step, d.notice) == (True, EVENT_HALT, 7, True)
    assert not c.decide().diverged
    with pytest.raises(NotImplementedError, match="item 8"):
        Coordinator(enabled=True)
