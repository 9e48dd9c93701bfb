"""A NaN injected mid-chunk at k steps per dispatch on the CPU: the port's digits loop against the live JAX loop (``test_torch_dispatch.py`` holds the rest)."""

from __future__ import annotations

import pytest
import torch

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.resilience import inject as jax_inject
from dwt_tpu.train import harvest as jax_harvest
from dwt_tpu.train import loop as jax_loop
from dwt_tpu_torch.config import DigitsConfig
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.train import harvest, loop
from test_torch_dispatch import DIGITS, _compare, _jax_lenet_init, _Records


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()
    jax_inject.disarm()


GUARD_KINDS = ("divergence", "lr_backoff", "lr_recover", "skip_step", "rollback")


@pytest.mark.parametrize("policy,plan,extra", [
    ("rollback", {"nan_at_step": 6}, dict(epochs=3, guard_interval=2)),
    # The flag drains at epoch 2's end; epoch 3's first boundary acts on it.
    ("skip_step", {"nan_at_step": 5}, dict(epochs=3, guard_interval=1)),
])
def test_nan_mid_chunk_guard_records_match_the_jax_loop(policy, plan, extra,
                                                        tmp_path, monkeypatch):
    """4 steps an epoch in chunks of 3 + 1 at depth 2: the NaN lands inside
    a chunk; its flags reach the guard when the ring overflows or at the
    epoch's drain, in both packages alike (no copy counts as landed early)."""
    monkeypatch.setattr(harvest._Entry, "ready", lambda self: False)
    monkeypatch.setattr(jax_harvest._Entry, "ready", lambda self: False)
    flags = dict(DIGITS, **extra, guard_policy=policy, steps_per_dispatch=3,
                 harvest_depth=2, ckpt_every_epochs=1)
    jax_inject.arm(jax_inject.FaultPlan.from_spec(plan))
    ref = _Records()
    jax_loop.run_digits(JaxDigitsConfig(**flags, ckpt_dir=str(tmp_path / "jax")), ref)
    inject.arm(inject.FaultPlan.from_spec(plan))
    ours = []
    loop.run_digits(DigitsConfig(**flags, ckpt_dir=str(tmp_path / "ours"), device="cpu"),
                    lambda kind, step, **f: ours.append((kind, step, f)),
                    model=_jax_lenet_init(16))
    guard = [(k, s, f) for k, s, f in ours if k in GUARD_KINDS]
    ref_guard = [(k, s, f) for k, s, f in ref.records if k in GUARD_KINDS]
    assert guard == ref_guard
    assert guard and guard[0][0] == "divergence"
    assert guard[0][2]["detected_at"] >= guard[0][1]
    _compare([r for r in ours if r[0] in ("train", "test")],
             [r for r in ref.records if r[0] in ("train", "test")],
             ("cls_loss", "entropy_loss"))
