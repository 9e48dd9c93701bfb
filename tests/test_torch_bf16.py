"""Port parity: the bf16 compute path of ``dwt_tpu_torch`` against the live JAX package.

The same seeded numpy inputs, rounded to bf16, go through the JAX package
and the port: the bf16 plain versions of both kernels against the Pallas
``_moments_call``/``_apply_call`` in interpret mode, ``group_whiten`` in
bf16 for all three backends, the bf16 BN folding, the four faults this
path repaired (each shown against JAX, and against what the port did
before), the ``--compute_dtype``/``--bf16`` resolution and CLI flags, the
digits trainer's accuracy band per backend, and SWBN's skipped stat
collection.  The bf16 model steps and serving are in
``test_torch_bf16_models.py``.

Tolerances: JAX's own bf16 tolerance ``rtol = atol = 2e-2``
(``tests/test_pallas_whitening.py:65``) for bf16 outputs; the moments of a
bf16 input, which both sides compute in f32, at the f32 moments
tolerances (mean ``rtol = atol = 1e-6``, cov ``rtol = 1e-4, atol =
1e-5``); where the port now rounds where JAX rounds, one bf16 rounding
step (:func:`_within_one_step`: ``2⁻⁸`` of the larger magnitude, plus
1e-6) — or bitwise, where the readings are bitwise.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.config import resolve_compute_dtype as jax_resolve
from dwt_tpu.ops import whitening as jw
from dwt_tpu.ops.pallas_whitening import _apply_call, _moments_call, pallas_group_whiten
from dwt_tpu_torch.cli import officehome, usps_mnist
from dwt_tpu_torch.config import (
    DigitsConfig,
    OfficeHomeConfig,
    model_dtype,
    resolve_compute_dtype,
)
from dwt_tpu_torch.ops import cuda_whitening as cw
from dwt_tpu_torch.ops import whitening as tw
from dwt_tpu_torch.train import loop
from dwt_tpu_torch.train.optim import grads_in_param_dtype

# The modules, not the functions the packages re-export under their names.
jax_bn = importlib.import_module("dwt_tpu.ops.batch_norm")
tbn = importlib.import_module("dwt_tpu_torch.ops.batch_norm")

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
COV_TOL = dict(rtol=1e-4, atol=1e-5)
M = 1000  # not a multiple of the Pallas kernels' 512-row tile
BACKENDS = ("cholesky", "newton_schulz", "swbn")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _bf16_pair(a):
    """``a`` rounded to bf16, as a JAX and a torch array holding the same
    values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).numpy()
    return np.asarray(a).astype(np.float64)


def _within_one_step(ours, ref):
    """``|a − b| ≤ 2⁻⁸·max(|a|, |b|) + 1e-6`` elementwise: at most one bf16
    rounding step apart."""
    a, b = _f64(ours), _f64(ref)
    return np.abs(a - b) <= 2.0 ** -8 * np.maximum(np.abs(a), np.abs(b)) + 1e-6


def _spd(rng, n, g=4):
    a = rng.normal(size=(n, g, g))
    return (a @ np.swapaxes(a, -1, -2) / g + 0.5 * np.eye(g)).astype(np.float32)


def _site(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(M, c)).astype(np.float32)
    mean = rng.normal(0.5, 0.5, size=(c,)).astype(np.float32)
    w = np.array(jw.whitening_matrix(jw._shrink(jnp.asarray(_spd(rng, c // 4)), 1e-3)))
    return x, mean, w


# --------------------------------------------------- the kernels' plain bf16


@pytest.mark.parametrize("c", [32, 48, 64, 256])
def test_bf16_apply_plain_matches_apply_call(c):
    """The bf16 apply's plain version (the CUDA kernel's rounding points)
    against ``_apply_call`` on the same bf16 ``x``: the output bf16, at
    most one bf16 rounding step apart everywhere."""
    x, mean, w = _site(c, c)
    jx, tx = _bf16_pair(x)
    ref = _apply_call(jx, jnp.asarray(mean), jnp.asarray(w), interpret=True)
    ours = cw.whiten_apply_plain(tx, torch.from_numpy(mean), torch.from_numpy(w))
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f64(ours), _f64(ref), **BF16_TOL)
    assert _within_one_step(ours, ref).all()
    # The same through the wrapper, one domain and two.
    assert torch.equal(cw.whiten_apply(tx, torch.from_numpy(mean), torch.from_numpy(w)), ours)
    both = cw.whiten_apply(torch.stack([tx, tx]), torch.from_numpy(np.stack([mean] * 2)),
                           torch.from_numpy(np.stack([w] * 2)))
    assert torch.equal(both[1], ours)


@pytest.mark.parametrize("c", [32, 48, 64, 256])
def test_bf16_moments_plain_matches_moments_call(c):
    """The moments of a bf16 ``x``, f32 out, against ``_moments_call`` on
    the same bf16 input at the f32 moments tolerances."""
    x, _, _ = _site(c, c + 1)
    jx, tx = _bf16_pair(x)
    ref_mean, ref_cov = _moments_call(jx, c // 4, 4, interpret=True)
    mean, cov = cw.whiten_moments_plain(tx, 4)
    assert mean.dtype == cov.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), **MEAN_TOL)
    np.testing.assert_allclose(cov.numpy(), np.asarray(ref_cov), **COV_TOL)
    means, covs = cw.whiten_moments(torch.stack([tx, tx.flip(0)]), 4)
    assert torch.equal(means[0], mean) and torch.equal(covs[0], cov)


@pytest.mark.parametrize("name", BACKENDS)
def test_group_whiten_bf16_matches_jax(name):
    """Train (output, every stat f32) and eval mode of ``group_whiten`` on
    bf16 activations, per backend, through the plain op and through the
    kernel seam ``cuda_group_whiten``."""
    rng = np.random.default_rng(7)
    x = rng.normal(0.5, 2.0, size=(2, M // 2, 16)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    jstats = jw.get_whitener(name).init_stats(16, 4)
    tstats = tw.get_whitener(name).init_stats(16, 4)
    y_ref, new_ref = jw.group_whiten(jx, jstats, group_size=4, train=True,
                                     whitener=name)
    e_ref, _ = jw.group_whiten(jx, new_ref, group_size=4, train=False, whitener=name)
    for fn in (tw.group_whiten, cw.cuda_group_whiten):
        y, new = fn(tx, tstats, group_size=4, train=True, whitener=name)
        assert y.dtype == torch.bfloat16 and all(s.dtype == torch.float32 for s in new)
        np.testing.assert_allclose(_f64(y), _f64(y_ref), **BF16_TOL)
        for field, ours, ref in zip(new._fields, new, new_ref):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=field,
                                       rtol=1e-5, atol=1e-5)
        e, _ = fn(tx, new, group_size=4, train=False, whitener=name)
        assert e.dtype == torch.bfloat16
        np.testing.assert_allclose(_f64(e), _f64(e_ref), **BF16_TOL)


def test_batch_norm_bf16_folds_as_jax():
    """BN on bf16 activations: f32 moments and stats, the f32 scale and
    shift folded into bf16 — bitwise JAX's, train and eval, on inputs
    whose mean (20) is large against their spread (1), where the fold's
    rounding shows."""
    rng = np.random.default_rng(8)
    jx, tx = _bf16_pair(rng.normal(20.0, 1.0, size=(64, 8)))
    y_ref, new_ref = jax_bn.batch_norm(jx, jax_bn.init_batch_norm_stats(8), train=True)
    y, new = tbn.batch_norm(tx, tbn.init_batch_norm_stats(8), train=True)
    assert y.dtype == torch.bfloat16 and new.mean.dtype == new.var.dtype == torch.float32
    np.testing.assert_array_equal(_f64(y), _f64(y_ref))
    for ours, ref in zip(new, new_ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    e_ref, _ = jax_bn.batch_norm(jx, new_ref, train=False)
    e, _ = tbn.batch_norm(tx, new, train=False)
    np.testing.assert_array_equal(_f64(e), _f64(e_ref))
    y3, _ = tbn.domain_batch_norm(torch.stack([tx, tx]), tbn.BatchNormStats(
        *(s.unsqueeze(0).repeat(2, *([1] * s.dim())) for s in tbn.init_batch_norm_stats(8))))
    assert torch.equal(y3[1], y)


# ----------------------------------------------------- the repaired faults


def test_fault_a_eval_factorizes_in_f32_with_the_f32_mean():
    """(a) The kernel seam's eval: the f32 eval matrix and the f32 running
    mean, as ``pallas_group_whiten`` (interpret mode).  Rounding the mean
    to bf16 first, as the seam did, is further from JAX."""
    rng = np.random.default_rng(9)
    jx, tx = _bf16_pair(rng.normal(3.0, 1.0, size=(M, 32)))
    mean = rng.normal(3.0, 0.3, size=(32,)).astype(np.float32)
    cov = _spd(rng, 8)
    ref, _ = pallas_group_whiten(jx, jw.WhiteningStats(jnp.asarray(mean), jnp.asarray(cov)),
                                 group_size=4, train=False, interpret=True)
    stats = tw.WhiteningStats(torch.from_numpy(mean), torch.from_numpy(cov))
    ours, _ = cw.cuda_group_whiten(tx, stats, group_size=4, train=False)
    assert _within_one_step(ours, ref).all()
    w = tw.get_whitener(None).eval_matrix(stats, 1e-3)
    old = cw.whiten_apply_plain(tx, stats.mean.bfloat16().float(), w)
    assert not _within_one_step(old, ref).all()


def test_fault_b_the_plain_op_rounds_where_jax_rounds():
    """(b) The plain op's apply: ``xn`` and ``w`` rounded to bf16 before
    the f32-accumulated product (train and eval), as JAX's
    ``apply_whitening(compute_dtype=bf16)``; applying in f32 and rounding
    only the output, as the op did, is further from JAX."""
    rng = np.random.default_rng(10)
    jx, tx = _bf16_pair(rng.normal(3.0, 2.0, size=(M, 32)))
    stats = (rng.normal(3.0, 0.3, size=(32,)).astype(np.float32), _spd(rng, 8))
    ref, _ = jw.group_whiten(jx, jw.WhiteningStats(*map(jnp.asarray, stats)),
                             group_size=4, train=False)
    tstats = tw.WhiteningStats(*map(torch.from_numpy, stats))
    ours, _ = tw.group_whiten(tx, tstats, group_size=4, train=False)
    assert _within_one_step(ours, ref).all()
    w = tw.get_whitener(None).eval_matrix(tstats, 1e-3)
    old = tw.apply_whitening(tx.float() - tstats.mean, w).bfloat16()
    assert not _within_one_step(old, ref).all()
    ref_t, _ = jw.group_whiten(jx, jw.init_whitening_stats(32, 4), group_size=4, train=True)
    ours_t, _ = tw.group_whiten(tx, tw.init_whitening_stats(32, 4), group_size=4, train=True)
    assert _within_one_step(ours_t, ref_t).mean() > 0.999
    np.testing.assert_allclose(_f64(ours_t), _f64(ref_t), **BF16_TOL)


def test_fault_c_bn_folds_instead_of_normalizing_in_f32():
    """(c) BN on bf16: JAX folds the scale and shift into bf16; the port's
    former f32 centred form differs from it wherever the fold rounds."""
    rng = np.random.default_rng(11)
    jx, tx = _bf16_pair(rng.normal(20.0, 1.0, size=(64, 8)))
    ref, _ = jax_bn.batch_norm(jx, jax_bn.init_batch_norm_stats(8), train=True)
    ours, _ = tbn.batch_norm(tx, tbn.init_batch_norm_stats(8), train=True)
    np.testing.assert_array_equal(_f64(ours), _f64(ref))
    xf = tx.float()
    m = xf.mean(0)
    old = ((xf - m) * torch.rsqrt((xf * xf).mean(0) - m * m + 1e-5)).bfloat16()
    assert (_f64(old) != _f64(ref)).mean() > 0.5


@pytest.mark.parametrize("name", ["newton_schulz", "swbn"])
def test_fault_d_the_kernel_seam_runs_the_sites_whitener(name):
    """(d) The kernel seam's train mode and its backward recompute with
    the site's whitener (f32), as JAX's ``group_whiten``; Cholesky, which
    the seam had wired in, gives another output."""
    rng = np.random.default_rng(12)
    x = rng.normal(0.5, 2.0, size=(M, 16)).astype(np.float32)
    r = rng.normal(size=(M, 16)).astype(np.float32)
    jstats = jw.get_whitener(name).init_stats(16, 4)
    ref, new_ref = jw.group_whiten(jnp.asarray(x), jstats, group_size=4, train=True,
                                   whitener=name)
    g_ref = jax.grad(lambda v: jnp.sum(jw.group_whiten(
        v, jstats, group_size=4, train=True, whitener=name)[0] * r))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ours, new = cw.cuda_group_whiten(xt, tw.get_whitener(name).init_stats(16, 4),
                                     group_size=4, train=True, whitener=name)
    (ours * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new[-1].numpy(), np.asarray(new_ref[-1]), rtol=1e-5, atol=1e-5)
    chol, _ = cw.cuda_group_whiten(torch.from_numpy(x), tw.init_whitening_stats(16, 4),
                                   group_size=4, train=True)
    assert not np.allclose(chol.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-3)


def test_grads_in_param_dtype_widens_reduced_precision_grads():
    """JAX's step-side cast: a bf16 gradient widens to its f32 parameter's
    dtype before the optimizer; f32 gradients are untouched (the same
    tensors)."""
    lin = torch.nn.Linear(3, 2)
    lin.weight.grad_dtype = None  # let a bf16 gradient in
    lin.weight.grad = torch.ones(2, 3, dtype=torch.bfloat16)
    bias_grad = lin.bias.grad = torch.ones(2)
    grads_in_param_dtype(lin)
    assert lin.weight.grad.dtype == torch.float32 and lin.bias.grad is bias_grad


# ------------------------------------------------------------ configuration


def test_resolve_compute_dtype_default_and_alias():
    """As ``tests/test_precision.py``: f32 by default, ``--bf16`` an alias,
    an unknown name refused — each case as the JAX package resolves it."""
    for kw in ({}, {"compute_dtype": "bf16"}, {"bf16": True},
               {"bf16": True, "compute_dtype": "f32"}):
        assert resolve_compute_dtype(DigitsConfig(**kw)) == jax_resolve(JaxDigitsConfig(**kw))
    assert resolve_compute_dtype(OfficeHomeConfig(bf16=True)) == "bf16"
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_compute_dtype(DigitsConfig(compute_dtype="fp8"))
    assert model_dtype("f32") is None and model_dtype("bf16") is torch.bfloat16


def test_cli_exposes_compute_dtype_flags():
    """Both CLIs take ``--compute_dtype``, ``--bf16`` and ``--whitener``
    (OfficeHome also ``--remat``) into their configs, with JAX's choices;
    an unknown whitener is refused by the parser."""
    for mod in (usps_mnist, officehome):
        cfg = mod.config_from_args(mod.build_parser().parse_args(
            ["--compute_dtype", "bf16", "--whitener", "swbn"]))
        assert (cfg.compute_dtype, cfg.whitener) == ("bf16", "swbn")
        cfg = mod.config_from_args(mod.build_parser().parse_args(["--bf16"]))
        assert resolve_compute_dtype(cfg) == "bf16"
        with pytest.raises(SystemExit):
            mod.build_parser().parse_args(["--whitener", "zca"])
    cfg = officehome.config_from_args(officehome.build_parser().parse_args(["--remat"]))
    assert cfg.remat and not OfficeHomeConfig().remat


def test_default_numerics_flags_are_the_default_run():
    """``--compute_dtype f32 --whitener cholesky`` is the default run: the
    same records and the same final parameters."""
    def run(extra):
        args = usps_mnist.build_parser().parse_args(
            ["--synthetic", "--group_size", "4", "--synthetic_size", "32",
             "--source_batch_size", "8", "--target_batch_size", "8", "--epochs", "1",
             "--num_workers", "0", "--device", "cpu"] + extra)
        cfg = usps_mnist.config_from_args(args)
        model, records = loop.build_digits_model(cfg), []
        loop.run_digits(cfg, lambda k, s, **f: records.append(
            (k, s, {a: b for a, b in f.items() if a not in (
                "eval_s", "eval_imgs_per_s", "dispatch_ms_p50", "dispatch_ms_p99")})), model=model)
        return records, [p.detach().clone() for p in model.parameters()]

    (r0, p0), (r1, p1) = run([]), run(["--compute_dtype", "f32", "--whitener", "cholesky"])
    assert r0 == r1 and all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("name", BACKENDS)
def test_digits_cli_bf16_band_per_backend(name):
    """End-of-run accuracy under ``--compute_dtype bf16`` within JAX's band
    of the f32 run (12.5 points, ``tests/test_precision.py:271``), per
    backend, the JAX twin's run shape: 32 synthetic images, batches of 8,
    2 epochs."""
    def acc(extra):
        return usps_mnist.main(
            ["--synthetic", "--synthetic_size", "32", "--source_batch_size", "8",
             "--target_batch_size", "8", "--test_batch_size", "16", "--group_size", "4",
             "--epochs", "2", "--log_interval", "100", "--num_workers", "0",
             "--device", "cpu", "--whitener", name] + extra)

    acc_f32, acc_bf16 = acc([]), acc(["--compute_dtype", "bf16"])
    assert abs(acc_f32 - acc_bf16) <= 12.5, (name, acc_f32, acc_bf16)


def test_swbn_skips_the_stat_collection_as_jax():
    """OfficeHome with ``--whitener swbn --stat_collection_passes 0``: the
    JAX loop's ``stat_collection`` record with ``skipped=True`` (its fields:
    ``dwt_tpu/train/loop.py`` logs ``skipped`` and ``whitener``); with
    passes asked for, its warning and then the passes."""
    def records(passes):
        cfg = OfficeHomeConfig(synthetic=True, arch="tiny", num_classes=4, img_crop_size=16,
                               source_batch_size=2, synthetic_size=4, num_iters=1,
                               check_acc_step=100, stat_collection_passes=passes,
                               num_workers=0, whitener="swbn", device="cpu")
        out = []
        loop.run_officehome(cfg, lambda k, s, **f: out.append((k, s, f)))
        return out

    skipped = [r for r in records(0) if r[0] == "stat_collection"]
    assert skipped == [("stat_collection", 1, {"skipped": True, "whitener": "swbn"})]
    kinds = [k for k, _, _ in records(1)]
    assert kinds[kinds.index("warning") + 1] == "stat_collection"
