"""Resume and the train→serve handoff of the port's two trainers on the CPU.

* The digits loop resumed at an epoch boundary equals its uninterrupted
  run bitwise (records, parameters, stats, optimizer state), and the JAX
  digits loop resumed the same way (``tests/test_loop_cli.py``'s pattern)
  gives the port's train losses within ``LOSS_TOL = 1e-4`` (the two
  frameworks' convolutions and reductions sum in other orders), from
  weights tied through the bridge.
* The tiny OfficeHome loop cut mid-run by a raising logger and resumed
  equals the uninterrupted run bitwise, with the same batch ids; its
  ``best_gr_4/`` and ``best.json`` follow the JAX loop's rules.
* ``--ckpt_dir`` serving: the server's engine on a trained checkpoint
  gives the trainer's eval forward of the trained model (``SERVE_TOL``
  relative to the logits' scale), and reports its step in ``/healthz``
  and ``/infer``.
"""

from __future__ import annotations

import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.train import loop as jax_loop
from dwt_tpu.utils.metrics import MetricLogger
from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data import loader
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.serve import server
from dwt_tpu_torch.serve.batcher import pad_to_bucket
from dwt_tpu_torch.train import loop
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.utils import checkpoint as ckpt

LOSS_TOL = 1e-4
# The served forward against the trainer's: the engine re-lays every conv
# weight channels_last, which gives a 1×1 kernel other strides than the
# trainer's copy, and the CPU's convolutions another summation order
# (reading: 1.4e-7 of the logits' scale).
SERVE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six test processes on the
    box's cores, and small models gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
DIGITS = dict(synthetic=True, synthetic_size=64, log_interval=1, group_size=4,
              seed=1, ckpt_every_epochs=1)


class _Records(MetricLogger):
    def __init__(self):
        super().__init__(stream=io.StringIO())
        self.records = []

    def log(self, kind, step, sync=False, flush=False, **values):
        self.records.append((kind, step, values))


def _run_digits(ckpt_dir, epochs, model=None):
    records = []
    loop.run_digits(DigitsConfig(**DIGITS, epochs=epochs, ckpt_dir=ckpt_dir,
                                 device="cpu"),
                    lambda kind, step, **f: records.append((kind, step, f)),
                    model=model)
    return records


def _without_timings(records):
    drop = ("eval_s", "eval_imgs_per_s", "dispatch_ms_p50", "dispatch_ms_p99", "seconds",
            "restore_s", "dir")
    return [(k, s, {n: v for n, v in f.items() if n not in drop})
            for k, s, f in records if k not in ("checkpoint", "resume")]


def _final_state(ckpt_dir):
    return torch.load(os.path.join(ckpt_dir, str(ckpt.latest_step(ckpt_dir)),
                                   ckpt.STATE_FILE), weights_only=True)


def _assert_same_payload(a, b):
    assert a["step"] == b["step"]
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for k, buffers in a["optimizer"]["state"].items():
        for name, v in buffers.items():
            assert torch.equal(v, b["optimizer"]["state"][k][name]), (k, name)


def _jax_lenet_init():
    variables = jax.jit(lambda k: JaxLeNetDWT(group_size=4).init(
        k, jnp.zeros((2, 32, 28, 28, 1)), train=True))(jax.random.key(1))
    return load_jax_variables(LeNetDWT(group_size=4),
                              jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]))


def test_digits_resume_is_the_uninterrupted_run_and_jaxs(tmp_path):
    whole = _run_digits(str(tmp_path / "whole"), 2, _jax_lenet_init())
    first = _run_digits(str(tmp_path / "cut"), 1, _jax_lenet_init())
    second = _run_digits(str(tmp_path / "cut"), 2)
    resume = [r for r in second if r[0] == "resume"]
    assert resume == [("resume", 2, {
        "epoch": 1, "source": "checkpoint", "data": "exact", "cursor": 0,
        "restore_s": resume[0][2]["restore_s"]})]
    assert _without_timings(first + second) == [
        r for r in _without_timings(whole)
        if r[0] != "params_digest" or r[1] == 4][:3] + [
        ("params_digest", 2, first[-1][2])] + _without_timings(whole)[3:]
    assert [s for k, s, _ in whole if k == "checkpoint"] == [2, 4]
    _assert_same_payload(_final_state(str(tmp_path / "whole")),
                         _final_state(str(tmp_path / "cut")))
    # A resume of the finished run evaluates the restored model.
    again = _run_digits(str(tmp_path / "cut"), 2)
    assert [k for k, _, _ in again] == ["resume", "test", "params_digest"]
    # (A background save's record follows its write, so the last test
    # record is looked up by kind.)
    assert again[1][2]["accuracy"] == [f for k, _, f in whole if k == "test"][-1]["accuracy"]

    # The JAX loop, resumed the same way, from the same initial weights.
    ref = _Records()
    jax_ckpt = str(tmp_path / "jax")
    flags = {k: v for k, v in DIGITS.items()}
    jax_loop.run_digits(JaxDigitsConfig(**flags, epochs=1, ckpt_dir=jax_ckpt), ref)
    jax_loop.run_digits(JaxDigitsConfig(**flags, epochs=2, ckpt_dir=jax_ckpt), ref)
    ref_train = [(s, f) for k, s, f in ref.records if k == "train"]
    ours_train = [(s, f) for k, s, f in first + second if k == "train"]
    assert [s for s, _ in ref_train] == [s for s, _ in ours_train] == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(ours_train, ref_train):
        for key in ("cls_loss", "entropy_loss"):
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_TOL, err_msg=key)
    assert [s for k, s, _ in ref.records if k == "resume"] == [2]


OFFICEHOME = dict(synthetic=True, arch="tiny", num_classes=4, img_crop_size=32,
                  source_batch_size=2, synthetic_size=8, num_iters=6,
                  check_acc_step=3, stat_collection_passes=1, log_interval=1,
                  num_workers=2, ckpt_every_iters=3, device="cpu")


class _Cut(Exception):
    pass


def _run_officehome(ckpt_dir, monkeypatch, cut_at=None):
    """``(records, batch ids per stream)`` of one run; ``cut_at`` raises
    from the logger at that step's train record."""
    ids = {}
    inner = loader.batch_iterator

    def recording(*args, **kwargs):
        role = kwargs.get("quarantine_key")
        kwargs.pop("on_batch_ids", None)  # the plane's trail hook (off)
        return inner(*args, on_batch_ids=ids.setdefault(role, []).append, **kwargs)

    monkeypatch.setattr(loader, "batch_iterator", recording)
    records = []

    def logger(kind, step, **fields):
        records.append((kind, step, fields))
        if kind == "train" and step == cut_at:
            raise _Cut

    cfg = OfficeHomeConfig(**OFFICEHOME, ckpt_dir=ckpt_dir)
    try:
        loop.run_officehome(cfg, logger)
    except _Cut:
        pass
    monkeypatch.setattr(loader, "batch_iterator", inner)
    return records, ids


def test_officehome_cut_and_resumed_is_the_uninterrupted_run(tmp_path, monkeypatch):
    whole, whole_ids = _run_officehome(str(tmp_path / "whole"), monkeypatch)
    cut, cut_ids = _run_officehome(str(tmp_path / "cut"), monkeypatch, cut_at=4)
    rest, rest_ids = _run_officehome(str(tmp_path / "cut"), monkeypatch)
    assert rest[0][:2] == ("resume", 3)
    assert {k: rest[0][2][k] for k in ("source", "data", "cursor")} == {
        "source": "checkpoint", "data": "exact", "cursor": 3}
    # Bitwise: every record after the resume, and the final artifact.
    assert _without_timings(rest) == [
        r for r in _without_timings(whole) if r[1] > 3 or r[0] in (
            "stat_collection", "final_test", "params_digest")]
    assert _without_timings(cut)[:4] == _without_timings(whole)[:4]
    _assert_same_payload(_final_state(str(tmp_path / "whole")),
                         _final_state(str(tmp_path / "cut")))
    # The batch ids: the cut run's first 4 steps and the resumed run's 3
    # are the uninterrupted run's 6 (the prefetch thread of the cut run
    # may have built more).
    for role in ("source", "target"):
        assert len(whole_ids[role]) == 6
        assert cut_ids[role][:4] == whole_ids[role][:4]
        assert rest_ids[role] == whole_ids[role][3:]
    # Checkpoints at 3 and 6 (the final save replaced the cadence save at
    # 6 with the post-collection state); best_gr_4 keeps one step.
    assert ckpt.valid_steps(str(tmp_path / "whole")) == [3, 6]
    tests = [(s, f["accuracy"]) for k, s, f in whole if k == "test"]
    best = [s for k, s, _ in whole if k == "best"]
    assert best[0] == 3 and all(
        acc > max(a for t, a in tests if t < s) for s, acc in tests if s in best[1:])
    best_dir = str(tmp_path / "whole" / "best_gr_4")
    assert ckpt.valid_steps(best_dir) == [best[-1]]
    record = json.load(open(tmp_path / "whole" / "best.json"))
    assert record == {"accuracy": dict(tests)[best[-1]], "step": best[-1]}


def test_a_resume_keeps_the_best_record_and_a_fresh_run_does_not(tmp_path):
    root = tmp_path / "run"
    cfg = OfficeHomeConfig(**{**OFFICEHOME, "num_iters": 3,
                              "stat_collection_passes": 0}, ckpt_dir=str(root),
                           keep_ckpts=1, anchor_every=3)
    loop.run_officehome(cfg, lambda *a, **f: None)
    json.dump({"accuracy": 101.0, "step": 3}, open(root / "best.json", "w"))
    cfg.num_iters = 6
    kinds = []
    loop.run_officehome(cfg, lambda kind, step, **f: kinds.append(kind))
    assert kinds[0] == "resume" and "best" not in kinds
    assert json.load(open(root / "best.json"))["accuracy"] == 101.0
    # keep_ckpts prunes the main directory only: anchors and best_gr_4 stay.
    assert ckpt.valid_steps(str(root)) == [6]
    assert ckpt.valid_steps(ckpt.anchor_dir(str(root))) == [3, 6]
    assert ckpt.valid_steps(str(root / "best_gr_4")) == [3]
    # No checkpoint to resume: a best record of a dead run is ignored.
    shutil.rmtree(root / "6")
    shutil.rmtree(ckpt.anchor_dir(str(root)))
    kinds.clear()
    loop.run_officehome(cfg, lambda kind, step, **f: kinds.append(kind))
    assert kinds[0] == "train" and kinds.count("best") >= 1


@pytest.mark.parametrize("model", ["lenet", "tiny"])
def test_the_server_serves_what_the_trainer_saved(tmp_path, model):
    root = str(tmp_path / "run")
    if model == "lenet":
        trained = LeNetDWT(group_size=4)
        loop.run_digits(DigitsConfig(**DIGITS, epochs=1, ckpt_dir=root,
                                     device="cpu"), lambda *a, **f: None,
                        model=trained)
        flags, shape, step = ["--model", "lenet"], (28, 28, 1), 2
    else:
        cfg = OfficeHomeConfig(**{**OFFICEHOME, "num_iters": 3}, ckpt_dir=root)
        trained = loop.build_model(cfg)
        loop.run_officehome(cfg, lambda *a, **f: None, model=trained)
        flags, shape, step = (["--model", "tiny", "--num_classes", "4",
                               "--image_size", "32"], (32, 32, 3), 3)
    args = server.build_parser().parse_args(flags + [
        "--ckpt_dir", root, "--buckets", "1,8", "--device", "cpu"])
    engine = server.build_engine(args)
    assert (engine.step, engine.source) == (step, "checkpoint")
    x = np.random.default_rng(0).normal(size=(5,) + shape).astype(np.float32)
    trained.eval()
    install_whiten_cache(trained, make_whiten_cache(trained))
    with torch.inference_mode():  # the engine's padded bucket-8 batch
        want = trained(torch.from_numpy(pad_to_bucket(x, 8))).numpy()[:5]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(engine.infer(x, bucket=8), want,
                               rtol=SERVE_TOL, atol=SERVE_TOL * scale)
    client = server.ServeClient(engine)
    front = server.HttpFront(client, "127.0.0.1", 0)
    http = server.HttpServeClient("127.0.0.1", front.port)
    try:
        status, health = http.healthz()
        assert status == 200 and health["step"] == step
        status, reply = http.request("POST", "/infer", json.dumps(
            {"inputs": x[:1].tolist()}).encode())
        assert status == 200 and reply["step"] == step
    finally:
        http.close()
        front.close()
