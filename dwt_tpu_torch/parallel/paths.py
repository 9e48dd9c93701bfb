"""The JAX key paths of a port ``TrainState``'s tensors — what the sharding rules match.

A rules table (``parallel.plan``) is written against the JAX package's
``jax.tree_util.keystr`` paths: ``.params['conv1']['kernel']``,
``.batch_stats['dn1']['whitening'].cov``, the Adam moments
``.opt_state[0][1].mu['fc3']['kernel']``, the two-group SGD momentum
``.opt_state[0].inner_states['backbone'].inner_state[1].trace['conv1']
['kernel']``.  :func:`state_leaves` names every tensor of a port state by
the path it stands for, with its shape in the JAX layout and the map from
that layout to the port's (conv HWIO → OIHW: torch dim ``t`` holds JAX dim
``(3, 2, 0, 1)[t]``; dense ``[in, out]`` → ``[out, in]``), so the JAX
package's presets and rules files run unchanged on the port.  The model's
leaves come from the weight bridge's one table
(``convert.from_jax.jax_leaves``); the optimizer's from the optax chains
the two recipes' torch optimizers stand for (``train.optim``):

* ``torch.optim.Adam`` (digits: ``with_lr_backoff(adam_l2(...))``):
  ``exp_avg`` → ``.opt_state[0][1].mu<param>``, ``exp_avg_sq`` → ``.nu``,
  ``step`` → ``.opt_state[0][1].count``;
* ``torch.optim.SGD`` with momentum (OfficeHome: ``with_lr_backoff(
  multi_transform({head, backbone}))``, group 0 the head):
  ``momentum_buffer`` → ``.opt_state[0].inner_states['<label>'].
  inner_state[1].trace<param>``; with one group, ``.opt_state[0][1].trace``.

A moment is listed whether or not the optimizer has made it yet (torch
makes them at the first step), with its parameter's shape.  The host-side
scalars of the JAX chains (the schedule's count, the backoff scale) are
host numbers in the port (``TrainState.step``, ``lr_scale``) and have no
tensor.  Leaves come in ``jax.tree_util``'s flatten order (dict keys
sorted, named-tuple fields in order), as JAX's rule matcher visits them.

Imports torch only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from dwt_tpu_torch.convert.from_jax import jax_leaves

# Each optimizer's per-parameter state: torch key → (JAX container field,
# is a moment of the parameter's shape).
_ADAM = {"step": ("count", False), "exp_avg": ("mu", True), "exp_avg_sq": ("nu", True)}
_SGD = {"momentum_buffer": ("trace", True)}
_GROUP_LABELS = ("head", "backbone")  # train.optim.sgd_two_group's order


class StateLeaf(NamedTuple):
    """One tensor of a train state under its JAX path.  ``name`` is the
    model's state-dict key (an optimizer leaf: its parameter's);
    ``opt_key`` the optimizer state key (None: a model leaf); ``shape``
    the JAX layout's; ``perm`` as ``JaxLeaf.perm``."""

    keystr: str
    shape: Tuple[int, ...]
    perm: Optional[Tuple[int, ...]]
    name: str
    opt_key: Optional[str] = None
    order: Tuple = ()


def _dict_path(path: Sequence[str]) -> str:
    return "".join(f"['{k}']" for k in path)


def jax_shape(torch_shape: Sequence[int], perm: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """A port tensor's shape in the JAX layout."""
    if perm is None:
        return tuple(int(s) for s in torch_shape)
    out = [0] * len(perm)
    for t, j in enumerate(perm):
        out[j] = int(torch_shape[t])
    return tuple(out)


def _opt_table(optimizer) -> Dict[str, Tuple[str, bool]]:
    if isinstance(optimizer, torch.optim.Adam):
        return _ADAM
    if isinstance(optimizer, torch.optim.SGD):
        return _SGD
    raise ValueError(
        f"no JAX key paths for the state of {type(optimizer).__name__}: the "
        "sharding plan knows the recipes' Adam and SGD")


def _opt_prefix(optimizer, group_index: int) -> Tuple[str, Tuple]:
    """The keystr of a parameter group's optax state, and its sort key."""
    if isinstance(optimizer, torch.optim.SGD) and len(optimizer.param_groups) == 2:
        label = _GROUP_LABELS[group_index]
        return (f".opt_state[0].inner_states['{label}'].inner_state[1]",
                ((0, 0), (0, 0), (1, label), (0, 0), (0, 1)))
    return ".opt_state[0][1]", ((0, 0), (0, 0), (0, 1))


def state_leaves(model: nn.Module, optimizer=None,
                 shapes: Optional[Dict[str, Tuple[int, ...]]] = None) -> List[StateLeaf]:
    """Every tensor of the state ``(model, optimizer)`` as a
    :class:`StateLeaf`, in JAX's flatten order.  ``shapes`` overrides the
    torch shape of a model key (a sharded state's full shapes)."""
    shapes = shapes or {}
    out: List[StateLeaf] = []
    by_param: Dict[int, Tuple[str, Tuple, Tuple[int, ...], Optional[Tuple]]] = {}
    for leaf in jax_leaves(model):
        t = getattr(leaf.module, leaf.attr)
        shape = jax_shape(shapes.get(leaf.name, tuple(t.shape)), leaf.perm)
        if leaf.collection == "params":
            key = ".params" + _dict_path(leaf.path)
            order = (1,) + tuple((1, k) for k in leaf.path)
            by_param[id(t)] = (leaf.name, leaf.path, shape, leaf.perm)
        else:
            fields = list(leaf.module._stat_names) if leaf.path[-2] == "whitening" \
                else ["mean", "var", "count"]
            key = ".batch_stats" + _dict_path(leaf.path[:-1]) + f".{leaf.path[-1]}"
            order = (2,) + tuple((1, k) for k in leaf.path[:-1]) + (
                (0, fields.index(leaf.path[-1])),)
        out.append(StateLeaf(key, shape, leaf.perm, leaf.name, None, order))
    if optimizer is not None:
        table = _opt_table(optimizer)
        for gi, group in enumerate(optimizer.param_groups):
            prefix, prefix_order = _opt_prefix(optimizer, gi)
            for p in group["params"]:
                if id(p) not in by_param:
                    raise ValueError("an optimizer parameter is not one of the model's")
                name, path, shape, perm = by_param[id(p)]
                keys = list(table)
                if isinstance(optimizer, torch.optim.SGD) and not group.get("momentum"):
                    keys = []
                for key in keys:
                    field, moment = table[key]
                    fi = ("count", "mu", "nu", "trace").index(field)
                    if moment:
                        out.append(StateLeaf(
                            f"{prefix}.{field}" + _dict_path(path), shape, perm, name, key,
                            (3,) + prefix_order + ((0, fi),) + tuple((1, k) for k in path)))
                    else:
                        out.append(StateLeaf(f"{prefix}.{field}", (), None, name, key,
                                             (3,) + prefix_order + ((0, fi), (gi,))))
    # Adam's count is one leaf in JAX: keep its first occurrence.
    seen, unique = set(), []
    for leaf in sorted(out, key=lambda l: l.order):
        if leaf.opt_key is not None and not leaf.shape:
            if leaf.keystr in seen:
                continue
            seen.add(leaf.keystr)
        unique.append(leaf)
    return unique


def serve_leaves(model: nn.Module) -> List[StateLeaf]:
    """Every tensor of a serving generation of ``model`` as a
    :class:`StateLeaf` under the path of the JAX engine's serve state
    ``{"params", "batch_stats", "whiten_cache"}`` (``dwt_tpu.serve.
    engine.ServeEngine.build_state``), in JAX's flatten order:
    ``['params']['conv1']['kernel']``, ``['batch_stats']['dn1']
    ['whitening'].mean`` and, for each whitening site, its eval matrix
    ``['whiten_cache']['whiten_cache']['dn1']['w']`` (the site's module
    key ``<site>.eval_matrix``, shape ``[G, g, g]``: its stats' ``cov`` of
    one domain)."""
    out: List[StateLeaf] = []
    for leaf in state_leaves(model):
        head, _, rest = leaf.keystr[1:].partition("[")
        out.append(leaf._replace(keystr=f"['{head}'][{rest}",
                                 order=((1 if head == "params" else 0),) + leaf.order[1:]))
    from dwt_tpu_torch.nn.norms import whitening_sites

    for name, site in whitening_sites(model).items():
        path = tuple(name.split("."))
        out.append(StateLeaf(f"['whiten_cache']['whiten_cache']{_dict_path(path)}['w']",
                             tuple(int(s) for s in site.cov.shape[1:]), None,
                             f"{name}.eval_matrix", None,
                             (2, (1, "whiten_cache")) + tuple((1, k) for k in path)))
    return sorted(out, key=lambda l: l.order)
