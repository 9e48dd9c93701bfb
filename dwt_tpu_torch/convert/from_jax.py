"""Weight bridge: ``dwt_tpu`` (Flax) variables → the port's ``nn.Module``.

Takes the JAX package's ``params`` and ``batch_stats`` trees as nested
dicts of numpy arrays (stat structs may be dicts or named tuples, e.g.
``jax.tree.map(np.asarray, variables)``, or a JAX ``TrainState``'s
``params`` and ``batch_stats``) and loads them into a port module whose
submodule names are the Flax scope names.  Layouts:

* conv kernel HWIO → ``weight`` OIHW, bias (LeNet's convs) as is;
* dense kernel ``[in, out]`` → ``weight [out, in]``, bias as is;
* norm affine ``gamma``/``beta`` as is;
* LayerNorm ``scale`` → ``weight``, ``bias`` as is;
* a parameter of no conv, dense or norm module (ViT's ``pos_embed``) at
  its module's scope under its own name, as is;
* ``WhiteningStats`` → buffers ``mean [D, C]``, ``cov [D, G, g, g]``;
  ``SWBNStats`` also ``w [D, G, g, g]`` (a site of the ``swbn`` backend);
* ``BatchNormStats`` → buffers ``mean``/``var [D, C]``, ``count [D]``.

The inverse of the key/layout scheme of
``dwt_tpu/convert/torch_resnet.py``; :func:`jax_leaves` is that scheme as
one table (the sharding plan's key paths read it too,
``dwt_tpu_torch.parallel.paths``).  It fails loudly: a leaf the module
needs and the trees lack, a leaf of the wrong shape, and a leaf of the
trees that no module consumed are all errors.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch.nn.norms import DomainBatchNorm, DomainWhiten

Path = Tuple[str, ...]


def _node(tree: Any, path: Path, what: str) -> Any:
    node = tree
    for i, key in enumerate(path):
        if isinstance(node, dict) and key in node:
            node = node[key]
        elif hasattr(node, "_fields") and key in node._fields:
            node = getattr(node, key)
        else:
            raise KeyError(
                f"{what}: missing leaf {'/'.join(path)} "
                f"(no {key!r} under {'/'.join(path[:i]) or '<root>'})"
            )
    return node


def _get(tree: Any, path: Path, what: str) -> np.ndarray:
    return np.asarray(_node(tree, path, what))


def _check_whitener(mod: DomainWhiten, stats: Any, scope: Path) -> None:
    """Raise unless the site's stats in the tree are its backend's: swbn's
    carry the tracked ``w``, the factorizing backends' do not."""
    names = stats._fields if hasattr(stats, "_fields") else tuple(stats)
    if ("w" in names) != ("w" in mod._stat_names):
        held = "the swbn whitener" if "w" in names else "a factorizing whitener"
        raise ValueError(
            f"batch_stats: {'/'.join(scope)} holds the whitening stats of "
            f"{held}, not those of the model's whitener {mod.whitener!r}")


def _leaf_paths(tree: Any, prefix: Path = ()) -> List[Path]:
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    else:
        return [prefix]
    out: List[Path] = []
    for key, value in items:
        out.extend(_leaf_paths(value, prefix + (key,)))
    return out


def _copy(dst: torch.Tensor, value: np.ndarray, path: Path, what: str) -> None:
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(
            f"{what}: leaf {'/'.join(path)} has shape {tuple(value.shape)}, "
            f"the module expects {tuple(dst.shape)}"
        )
    dst.copy_(torch.tensor(value, dtype=dst.dtype))


class JaxLeaf(NamedTuple):
    """One tensor of a port module and the Flax leaf it stands for:
    ``module.<attr>`` (the model's state-dict key ``name``) holds the leaf
    at ``path`` of the ``collection`` tree (``"params"`` or
    ``"batch_stats"``); ``perm`` is the layout map, torch dim ``t``
    holding Flax dim ``perm[t]`` (None: the same layout)."""

    module: nn.Module
    attr: str
    name: str
    collection: str
    path: Path
    perm: Optional[Tuple[int, ...]]


def jax_leaves(model: nn.Module) -> List[JaxLeaf]:
    """Every parameter and running statistic of ``model`` as its Flax leaf
    (the module docstring's scheme), in module order — the one table the
    weight bridge and ``parallel.paths`` read."""
    out: List[JaxLeaf] = []

    def add(mod, scope, attr, col, path, perm=None):
        name = ".".join(scope + (attr,))
        out.append(JaxLeaf(mod, attr, name, col, scope + path, perm))

    for name, mod in model.named_modules():
        scope: Path = tuple(name.split(".")) if name else ()
        if isinstance(mod, nn.Conv2d):
            add(mod, scope, "weight", "params", ("kernel",), (3, 2, 0, 1))
            if mod.bias is not None:
                add(mod, scope, "bias", "params", ("bias",))
        elif isinstance(mod, nn.Linear):
            add(mod, scope, "weight", "params", ("kernel",), (1, 0))
            add(mod, scope, "bias", "params", ("bias",))
        elif isinstance(mod, nn.LayerNorm):
            add(mod, scope, "weight", "params", ("scale",))
            add(mod, scope, "bias", "params", ("bias",))
        elif isinstance(mod, (DomainWhiten, DomainBatchNorm)):
            for leaf in ("gamma", "beta"):
                add(mod, scope, leaf, "params", (leaf,))
            if isinstance(mod, DomainWhiten):
                stat_leaves = [("whitening", n) for n in mod._stat_names]
            else:
                stat_leaves = (("bn", "mean"), ("bn", "var"), ("bn", "count"))
            for kind, leaf in stat_leaves:
                add(mod, scope, leaf, "batch_stats", (kind, leaf))
        else:
            for leaf, _ in mod.named_parameters(recurse=False):
                add(mod, scope, leaf, "params", (leaf,))
    return out


@torch.no_grad()
def load_jax_variables(
    model: nn.Module, params: Dict[str, Any], batch_stats: Dict[str, Any]
) -> nn.Module:
    """Load the Flax ``params``/``batch_stats`` trees into ``model`` in
    place; returns ``model``."""
    used: Set[Tuple[str, Path]] = set()
    trees = {"params": params, "batch_stats": batch_stats}
    checked: Set[int] = set()
    for leaf in jax_leaves(model):
        if leaf.collection == "batch_stats" and isinstance(leaf.module, DomainWhiten) \
                and id(leaf.module) not in checked:
            checked.add(id(leaf.module))
            scope = leaf.path[:-2]
            _check_whitener(leaf.module, _node(batch_stats, scope + ("whitening",),
                                               "batch_stats"), scope)
        used.add((leaf.collection, leaf.path))
        value = _get(trees[leaf.collection], leaf.path, leaf.collection)
        if leaf.perm is not None:
            value = np.transpose(value, leaf.perm)
        _copy(getattr(leaf.module, leaf.attr), value, leaf.path, leaf.collection)

    for col, tree in trees.items():
        extra = [p for p in _leaf_paths(tree) if (col, p) not in used]
        if extra:
            raise ValueError(
                f"{col}: {len(extra)} leaves match no module of "
                f"{type(model).__name__}, e.g. {'/'.join(extra[0])}"
            )
    return model
