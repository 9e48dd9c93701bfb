"""k steps per dispatch on the CPU: the port's chunked paths against its own single steps and against the JAX loops.

* ``make_scanned_step``: k eager steps of a chunk are bitwise k single
  steps (the plain version of the card's graph runner); bad k raises.
* ``_chunk_stream`` cuts where the JAX loop's does (eval, checkpoint and
  anchor cadences; a digits epoch's end).
* The chunked eval gives bitwise the counters of one batch per dispatch,
  a ragged tail included; the scanned collection the stats of one batch
  per forward.
* The digits trainer at ``--steps_per_dispatch 3 --harvest_depth 2``
  against the live JAX loop with the same flags, from weights tied through
  the bridge: the same record steps, train losses within ``LOSS_TOL`` (the
  two frameworks' convolutions sum in other orders), the same accuracies;
  depth 2 emits the records of depth 0.  The tiny OfficeHome trainer is in
  ``test_torch_dispatch_officehome.py``, a NaN injected mid-chunk in
  ``test_torch_dispatch_guard.py`` (one file per worker: each stays under
  a minute).
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.train import loop as jax_loop
from dwt_tpu.utils.metrics import MetricLogger
from dwt_tpu_torch.config import DigitsConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data.datasets import ArrayDataset
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.train import loop, steps
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.optim import digits_tx
from dwt_tpu_torch.train.state import TrainState

LOSS_TOL = 1e-4
# Eval losses come from near-singular eval whitening (a few steps move the
# running covariances a fraction of the way from their all-ones init), so
# rounding differences reach the logits amplified; accuracies and counts
# are held exactly (as tests/test_torch_data_plane.py).
EVAL_LOSS_TOL = 1e-2
TIMING = ("eval_s", "eval_imgs_per_s", "dispatch_ms_p50", "dispatch_ms_p99", "seconds")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _digits_state(seed: int = 1) -> TrainState:
    model = build_lenet(group_size=4, seed=seed).to(memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, DigitsConfig(lr_milestones=(2,)), 2)
    return TrainState(model, optimizer, schedules)


def _digits_chunk(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"source_x": torch.from_numpy(rng.normal(size=(n, 8, 28, 28, 1)).astype(np.float32)),
            "source_y": torch.from_numpy(rng.integers(0, 10, size=(n, 8))),
            "target_x": torch.from_numpy(rng.normal(size=(n, 8, 28, 28, 1)).astype(np.float32))}


# ------------------------------------------------------- the chunked step


def test_k_eager_steps_equal_k_single_steps_bitwise():
    """Three steps, across an lr milestone (decay at step 2), one by one and
    as one chunk of the scanned step: the metrics stacked, the parameters,
    the stats and Adam's moments bitwise equal."""
    single, chunked = _digits_state(), _digits_state()
    chunk = _digits_chunk(3)
    step_a = steps.make_digits_train_step(single.model)
    rows = [step_a(single, {k: v[i] for k, v in chunk.items()}) for i in range(3)]
    scanned = steps.make_scanned_step(steps.make_digits_train_step(chunked.model), 3)
    stacked = scanned(chunked, chunk)
    assert single.step == chunked.step == 3
    for key, value in stacked.items():
        assert value.shape[0] == 3
        assert torch.equal(value, torch.stack([r[key] for r in rows])), key
    for (name, a), b in zip(single.model.state_dict().items(),
                            chunked.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(single.model.parameters(), chunked.model.parameters()):
        for key, value in single.optimizer.state[p].items():
            assert torch.equal(value, chunked.optimizer.state[q][key]), key


def test_scanned_step_rejects_bad_k_and_long_chunks():
    step = steps.make_digits_train_step(LeNetDWT(group_size=4))
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        steps.make_scanned_step(step, 0)
    with pytest.raises(ValueError, match="exceeds"):
        steps.make_scanned_step(step, 2)(_digits_state(), _digits_chunk(3))


@pytest.mark.parametrize("cadence", [
    dict(k=4, start=0, n=11, cut=lambda i: (i + 1) % 5 == 0),             # eval every 5
    dict(k=3, start=2, n=9, cut=lambda i: (i + 1) % 4 == 0 or (i + 1) % 6 == 0),  # eval, ckpt
    dict(k=4, start=0, n=6, cut=None),                                     # an epoch's end
], ids=["eval", "eval_ckpt_resumed", "epoch_end"])
def test_chunk_stream_cuts_where_the_jax_loop_does(cadence):
    batches = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(2) + i}
               for i in range(cadence["n"])]
    ours = list(loop._chunk_stream(iter(batches), cadence["k"], cadence["cut"],
                                   start=cadence["start"]))
    ref = list(jax_loop._chunk_stream(iter(batches), cadence["k"], cadence["cut"],
                                      start=cadence["start"]))
    assert [c["x"].shape[0] for c in ours] == [c["x"].shape[0] for c in ref]
    assert max(c["x"].shape[0] for c in ours) <= cadence["k"]
    for a, b in zip(ours, ref):
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


# ------------------------------------------------------ eval, collection


def _eval_dataset(n: int = 37, seed: int = 5) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    return ArrayDataset(rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                        rng.integers(0, 10, size=(n,)))


def test_chunked_eval_counters_equal_one_batch_per_dispatch():
    """37 images at batch 8: four full batches and a padded tail of 5, at
    1, 3 (chunks of 3 + 2) and 8 batches per dispatch; the stats moved off
    their init by one collection pass first."""
    state = _digits_state()
    data = _eval_dataset()
    EvalPipeline(8, "cpu", num_domains=2).collect_stats(state, data)
    results = [EvalPipeline(8, "cpu", num_domains=2, eval_k=k).evaluate(state, data)
               for k in (1, 3, 8)]
    for r in results:
        for key in TIMING:
            r.pop(key, None)
    assert results[0]["count"] == 37 and results[0]["forwards"] == 5
    assert results[0] == results[1] == results[2]
    with pytest.raises(ValueError, match="eval_steps_per_dispatch must be >= 1"):
        EvalPipeline(8, "cpu", num_domains=2, eval_k=0)


def test_scanned_collect_equals_per_batch_collection():
    a, b = _digits_state(), _digits_state()
    xs = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 8, 28, 28, 1)).astype(np.float32))
    collect = steps.make_stat_collection_step(a.model, 2)
    for i in range(4):
        collect(a, xs[i])
    steps.make_scanned_collect(steps.make_stat_collection_step(b.model, 2), 4)(b, xs)
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    # A pass with a ragged tail (37 = 4 × 8 + 5): the tail its own forward.
    c, d = _digits_state(), _digits_state()
    data = _eval_dataset()
    assert EvalPipeline(8, "cpu", 2, eval_k=1).collect_stats(c, data) == 5
    assert EvalPipeline(8, "cpu", 2, eval_k=8).collect_stats(d, data) == 5
    for (name, x), y in zip(c.model.state_dict().items(), d.model.state_dict().values()):
        assert torch.equal(x, y), name


# ----------------------------------------------- the loops against JAX's


class _Records(MetricLogger):
    def __init__(self):
        super().__init__(stream=io.StringIO())
        self.records = []

    def log(self, kind, step, sync=False, flush=False, **values):
        self.records.append((kind, step, values))


def _jax_lenet_init(batch: int):
    variables = jax.jit(lambda k: JaxLeNetDWT(group_size=4).init(
        k, jnp.zeros((2, batch, 28, 28, 1)), train=True))(jax.random.key(1))
    return load_jax_variables(LeNetDWT(group_size=4),
                              jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]))


def _compare(ours, ref, loss_keys):
    """Same record kinds and steps; losses within LOSS_TOL; same
    accuracies and counts."""
    kinds = {k for k, _, _ in ours}
    ref = [r for r in ref if r[0] in kinds]
    assert [(k, s) for k, s, _ in ours] == [(k, s) for k, s, _ in ref]
    for (kind, s, a), (_, _, b) in zip(ours, ref):
        if kind == "train":
            for key in loss_keys:
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_TOL,
                                           err_msg=f"{key} at step {s}")
        elif kind in ("test", "final_test"):
            assert (a["accuracy"], a["count"]) == (b["accuracy"], b["count"])
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=EVAL_LOSS_TOL)


DIGITS = dict(synthetic=True, synthetic_size=64, source_batch_size=16,
              target_batch_size=16, test_batch_size=16, log_interval=1,
              group_size=4, seed=1, epochs=2)


def _port_digits(model=None, **flags):
    records = []
    loop.run_digits(DigitsConfig(**{**DIGITS, **flags}, device="cpu"),
                    lambda kind, step, **f: records.append((kind, step, f)),
                    model=model if model is not None else _jax_lenet_init(16))
    return records


def _strip(records):
    return [(k, s, {n: v for n, v in f.items() if n not in TIMING}) for k, s, f in records]


def test_digits_chunked_and_harvested_matches_the_jax_loop():
    """4 steps an epoch in chunks of 3 + 1, depth 2: JAX's records; depth 0
    and one step per dispatch emit the same records bitwise."""
    flags = dict(steps_per_dispatch=3, harvest_depth=2)
    ref = _Records()
    jax_loop.run_digits(JaxDigitsConfig(**DIGITS, **flags), ref)
    ours = _port_digits(**flags)
    assert [k for k, _, _ in ours] == (["train"] * 4 + ["test"]) * 2 + ["params_digest"]
    _compare(ours, ref.records, ("cls_loss", "entropy_loss"))
    assert _strip(_port_digits(steps_per_dispatch=3, harvest_depth=0)) == _strip(ours)
    assert _strip(_port_digits(steps_per_dispatch=1, harvest_depth=0)) == _strip(ours)


def test_preempted_chunked_run_resumes_to_the_uninterrupted_run(tmp_path):
    """At k = 3 and depth 2, a save every epoch (4 steps): a SIGTERM at
    step 6 is seen at the boundary of the chunk 5–7, the run saves at 7
    and returns with a ``preempt`` record; the rerun resumes at 7 with the
    exact data position and ends with the uninterrupted run's parameters
    and train records."""
    from dwt_tpu_torch.resilience import inject

    flags = dict(steps_per_dispatch=3, harvest_depth=2, ckpt_every_epochs=1)
    whole = _port_digits(ckpt_dir=str(tmp_path / "whole"), **flags)
    inject.arm(inject.FaultPlan.from_spec({"sigterm_at_step": 6}))
    try:
        cut = _port_digits(ckpt_dir=str(tmp_path / "cut"), **flags)
    finally:
        inject.disarm()
    assert [(k, s) for k, s, _ in cut][-1] == ("preempt", 7)
    assert [s for k, s, _ in cut if k == "train"] == list(range(1, 8))
    resumed = _port_digits(ckpt_dir=str(tmp_path / "cut"), **flags)
    assert resumed[0][:2] == ("resume", 7) and resumed[0][2]["data"] == "exact"
    digest = lambda recs: [f["sha256"] for k, _, f in recs if k == "params_digest"]
    assert digest(resumed) == digest(whole)
    train = lambda recs: [(s, f) for k, s, f in recs if k == "train"]
    assert train(cut) + train(resumed) == train(whole)
