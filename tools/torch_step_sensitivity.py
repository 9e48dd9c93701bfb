#!/usr/bin/env python3
"""How sensitive the update of a ResNet50-DWT train step is, parameter by
parameter: the PyTorch port's step through the CUDA kernels, through
their plain versions and in float64, over several seeds, on a CUDA GPU.

Run from the root of a checkout on a machine with the card::

    python3 tools/torch_step_sensitivity.py [--seeds 2,12,22] [--images 18]
        [--size 224] [--backbone vit_dwt] [--out chiprun_out/step_sensitivity.json]

``--backbone`` takes any name of the backbone registry in place of
``--arch`` (``vit_dwt``: ViT-S/16, the readings behind ``chip_smoke.py``'s
``VIT_LEAF_TOL`` and ``VIT_NOISE_TOL``).
``--arch tiny --size 32 --images 8 --device cpu`` rehearses it on the
CPU (where both "kernel" steps take the plain versions).

Per seed (weights from ``seed``, batch from ``seed + 3``, as
``chip_smoke.py``'s reference step), four steps from the same state:

* ``kernel``: f32, through the moments and apply kernels;
* ``plain``: f32, both kernels swapped for their plain versions;
* ``f64``: the plain versions in float64;
* ``f64_perturbed``: float64 again, on the batch with every pixel moved
  by one f32 rounding unit (``x · (1 + u · 2⁻²⁴)``, ``u`` uniform in
  ``[−1, 1]``) — how far the exact step moves for an input change of
  f32's size, with no f32 arithmetic at all.

They are compared leaf by leaf with ``chip_smoke.compare_steps``; per
pair, ``checked_worst`` is the worst backbone and head leaf that
``chip_smoke.check_step`` holds to a limit (a ViT's zero-gradient biases
left out), and ``zero_grad_share`` each step's ``chip_smoke.noise_share``
of those biases.  Also per seed: how uniform the loss's gradient on the logits is across the
images of each stream (``logit_grad_spread``), the condition number of
every whitening site's shrunk batch
covariance (the worst group of each site and domain, recovered from the
float64 step's running-stat update), and, for the leaves whose f32
update is furthest from float64, the error that rounding the updated
parameter to float32 alone gives the update (``rounding_floor``: the
rms of a rounding, one f32 spacing over √12, over the step's norm),
the norms of the float64 gradient and of the weight-decay term.  Prints one
JSON line per seed, then the card (``nvidia-smi`` name and power limit);
the per-leaf tables go to ``--out``.  Fails without CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOP = 6  # leaves listed per seed


def site_conditions(torch, model, init, momentum):
    """Per whitening site: the largest condition number over domains and
    groups of the shrunk batch covariance, from the running-stat update
    ``new = momentum · batch + (1 − momentum) · old``."""
    from dwt_tpu_torch.nn.norms import whitening_sites
    from dwt_tpu_torch.ops.whitening import _shrink

    out = {}
    for name, site in whitening_sites(model).items():
        old = init[f"{name}.cov"].double().to(site.cov.device)
        batch = (site.cov.double() - (1.0 - momentum) * old) / momentum
        eig = torch.linalg.eigvalsh(_shrink(batch, site.eps))
        out[name] = float((eig[..., -1] / eig[..., 0]).max())
    return out


def logit_grad_spread(torch, cs, cfg, model, batch, device):
    """Per stream (source, target, augmented target): how much the loss's
    gradient with respect to the logits varies from image to image,
    ``‖g − mean_i g‖ / ‖g‖``, and ``‖g‖``, from a float64 train forward
    at the initial weights.  Near 0 means every image gets nearly the
    same gradient, which each domain's last norm site removes in its
    backward (its batch-mean projection): what survives is a small
    difference of large terms."""
    from dwt_tpu_torch.ops.losses import mec_loss, softmax_cross_entropy

    model = cs.float64_model(torch, model).to(device, memory_format=torch.channels_last)
    model.train()
    x = torch.stack([batch["source_x"], batch["target_x"], batch["target_aug_x"]])
    with torch.no_grad():
        logits = model(x)
    logits.requires_grad_(True)
    loss = (softmax_cross_entropy(logits[0], batch["source_y"])
            + cfg.lambda_mec_loss * mec_loss(logits[1], logits[2]))
    (g,) = torch.autograd.grad(loss, logits)
    out = {}
    for name, gd in zip(("source", "target", "target_aug"), g):
        norm = float(gd.norm())
        out[name] = {"spread": float((gd - gd.mean(dim=0)).norm()) / norm
                     if norm else None, "norm": norm}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="2,12,22")
    p.add_argument("--images", type=int, default=18, help="images per stream")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--arch", default="resnet50", choices=("resnet50", "tiny"))
    p.add_argument("--backbone", default=None,
                   help="a backbone registry name; overrides --arch")
    p.add_argument("--lambda_mec", type=float, default=None,
                   help="the MEC loss weight (default: the trainer's)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="chiprun_out/step_sensitivity.json")
    args = p.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_step_sensitivity: needs a CUDA GPU (or --device cpu)",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dwt_tpu_torch.config import OfficeHomeConfig
    from dwt_tpu_torch.ops import _build, cuda_whitening as cw
    from dwt_tpu_torch.train import loop

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        _build.build_all()
    tables = []
    small = (args.backbone or args.arch) in ("tiny", "vit_tiny")
    for seed in [int(s) for s in args.seeds.split(",")]:
        cfg = OfficeHomeConfig(seed=seed, arch=args.arch, backbone=args.backbone,
                               img_crop_size=args.size, source_batch_size=args.images,
                               num_classes=5 if small else 65)
        if args.lambda_mec is not None:
            cfg = dataclasses.replace(cfg, lambda_mec_loss=args.lambda_mec)
        batch = cs.synthetic_batch(torch, loop, args.images, args.size,
                                   cfg.num_classes, seed + 3, device)
        f64_batch = {k: v.double() if v.is_floating_point() else v
                     for k, v in batch.items()}
        gen = torch.Generator(device=device).manual_seed(seed)
        perturbed = {k: v * (1 + (torch.rand(v.shape, generator=gen, device=device,
                                             dtype=v.dtype) * 2 - 1) * 2.0 ** -24)
                     if v.is_floating_point() else v for k, v in f64_batch.items()}
        base = loop.build_model(cfg)
        zero = (cs.vit_zero_grad_leaves(base.depth)
                if cfg.backbone in ("vit_dwt", "vit_tiny") else ())
        init = {k: v.detach().clone() for k, v in base.state_dict().items()}
        steps = {"kernel": cs.one_step(torch, cfg, copy.deepcopy(base), batch, device)}
        kernels = (cw.whiten_moments, cw.whiten_apply)
        cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
        try:
            spread = logit_grad_spread(torch, cs, cfg, copy.deepcopy(base), f64_batch,
                                       device)
            steps["plain"] = cs.one_step(torch, cfg, copy.deepcopy(base), batch, device)
            steps["f64"] = cs.one_step(
                torch, cfg, cs.float64_model(torch, copy.deepcopy(base)),
                f64_batch, device)
            steps["f64_perturbed"] = cs.one_step(
                torch, cfg, cs.float64_model(torch, copy.deepcopy(base)),
                perturbed, device)
        finally:
            cw.whiten_moments, cw.whiten_apply = kernels
        pairs = {"kernel_vs_plain": ("kernel", "plain"),
                 "kernel_vs_f64": ("kernel", "f64"),
                 "plain_vs_f64": ("plain", "f64"),
                 "f64_perturbed_vs_f64": ("f64_perturbed", "f64")}
        errs = {name: cs.compare_steps(torch, steps[a], steps[b], init)
                for name, (a, b) in pairs.items()}
        f64_model = steps["f64"][1]
        f64_state = f64_model.state_dict()
        f64_params = dict(f64_model.named_parameters())
        by_leaf = errs["kernel_vs_f64"]["by_leaf"]
        worst = sorted(by_leaf, key=lambda k: -by_leaf[k]["update"])[:TOP]
        wd = cfg.weight_decay
        leaves = {}
        for k in worst:
            post = f64_state[k].double()
            step = float((post - init[k].to(post.device).double()).norm())
            leaves[k] = {
                **{name: e["by_leaf"][k] for name, e in errs.items()},
                # The rms error of rounding post to float32, over the step.
                "rounding_floor": float(cs.f32_ulp(torch, post).norm())
                / 12 ** 0.5 / step,
                "grad_norm_f64": float(f64_params[k].grad.norm()),
                "weight_decay_norm": float(wd * init[k].double().norm()),
                "param_rms": float(init[k].double().square().mean().sqrt()),
                "numel": init[k].numel(),
            }
        conds = site_conditions(torch, f64_model, init, cfg.running_momentum)
        row = {"seed": seed, "batch_seed": seed + 3,
               **{name: cs.leaf_summary(e) for name, e in errs.items()},
               "checked_worst": {name: cs.checked_worst(e, zero)
                                 for name, e in errs.items()},
               "zero_grad_share": {name: cs.noise_share(torch, st, zero)
                                   for name, st in steps.items()} if zero else {},
               "leaves": leaves, "whitening_site_condition": conds,
               "lambda_mec": cfg.lambda_mec_loss, "logit_grad_spread": spread}
        cs.emit(row)
        tables.append({**row, "by_leaf": {
            name: e["by_leaf"] for name, e in errs.items()}})
        del steps, base, f64_model, f64_state, f64_params
        torch.cuda.empty_cache()
    card = cs.nvidia_smi() if device.type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "arch": args.backbone or args.arch, "images": args.images,
                   "size": args.size, "seeds": tables}, f)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
