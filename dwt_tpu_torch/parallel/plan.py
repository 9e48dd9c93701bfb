"""The run's sharding plan — the port of ``dwt_tpu.parallel.plan``.

One :class:`ShardingPlan` is the training loops' one authority on how a
step runs and where the state lives, in one of three modes:

* ``single`` — one process, no collectives;
* ``replica`` — the ``dp`` preset: every state tensor replicated, one
  process per rank over a :class:`~dwt_tpu_torch.parallel.mesh.Mesh`, the
  step's collectives explicit (``dwt_tpu_torch.parallel.dp``);
* ``gspmd`` — any model-sharding rules table (the presets ``model`` and
  ``fsdp``, or a JSON rules file) over the ``(dcn, data, model)``
  :class:`~dwt_tpu_torch.parallel.mesh.PlanMesh`: each state tensor placed
  by its rule (``dwt_tpu_torch.parallel.gspmd``: a sharded tensor held as
  this rank's block, gathered around each forward), the batch sharded
  over every axis but ``model``, the norm sites' moments, the gradients,
  the metrics and the eval counters reduced over the data group (the ranks
  that share a ``model`` index), so every step is the global batch's, as
  JAX's axis-free step under ``jit`` is.

The plan hands the model its group (:attr:`ShardingPlan.group`: the mesh
in replica mode, the data group in gspmd mode, None in single; JAX's
``axis_name``), wraps the step factories, places and gathers the state and
decides the dispatch: under gloo a chunk's steps run eagerly
(:attr:`capture` False), under NCCL the replica step is captured as a CUDA
graph.  The gspmd steps always run eagerly: their gathers sit in forward
hooks, and no card test has held a captured gspmd step to an eager one.

**The rules** are the JAX module's, line for line, with the port's key
paths (``dwt_tpu_torch.parallel.paths``) in place of
``jax.tree_util.keystr``: an ORDERED list of ``(regex, P)`` rules matched
first-match-wins against every leaf's JAX path; scalars and
single-element leaves never partition; a leaf no rule matches raises
with the table; a spec that does not fit its leaf raises naming leaf,
rule and mesh (an indivisible classifier head names ``--pad_classes_to``);
an optimizer moment whose spec differs from its parameter's raises naming
both rules; a shadowed or duplicate rule warns.  The DWT contract of the
presets holds: the whitening and BN running stats (and the eval whiten
cache) stay replicated, their cross-replica moment averaging being the
paper's algorithm.

:func:`plan_from_flags` resolves the CLI surface (``--data_parallel``,
``--distributed``, ``--dcn_slices``, ``--mesh_shape``,
``--sharding_rules``) with the JAX package's decisions and error texts,
the group's size standing where JAX reads ``jax.device_count()``:

* ``--data_parallel`` on a one-rank group is ``single``, as JAX's is on
  one device; ``--data_parallel`` without ``--distributed`` on a host
  that shows more than one GPU raises (one process per device: nothing
  trains on one card of several by accident);
* the ``--pallas_whiten`` conflict, the dcn and mesh conflicts, the
  batch-divisibility errors and the warning when a rules table shards
  nothing are JAX's;
* a ``--mesh_shape`` must cover every rank of the group: a rank outside
  the mesh would train alone.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dwt_tpu_torch import obs
from dwt_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    PlanMesh,
    make_mesh,
    make_plan_mesh,
    process_count,
)

log = logging.getLogger(__name__)


class P(tuple):
    """A ``jax.sharding.PartitionSpec`` stand-in: one entry per leading
    dim, each ``None`` (whole), an axis name, or a tuple of names (a dim
    split over several axes, major to minor)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


Rule = Tuple[str, P]

# ------------------------------------------------------------------ presets
#
# The JAX package's tables.  "dp" replicates every state leaf.  "model"
# shards the weight-heavy kernels over MODEL_AXIS (conv kernels
# [kh, kw, in, out] on out channels, dense kernels [in, out] on out
# features) and keeps replicated the running stats and whiten cache (the
# paper's cross-replica moment averaging), the classifier heads (lenet
# fc5, resnet fc_out: num_classes rarely divides the axis) and everything
# else (biases, norm affines).  "fsdp" shards EVERY conv and dense kernel,
# the heads included (--pad_classes_to makes their out dim divisible).
# The rules match layer names, not containers, so the optimizer moments
# shard with their parameters; the 4-D conv rule must precede the generic
# dense one, or P(None, model) would shard a conv kernel's kw dim.
PRESETS = {
    "dp": [
        (r".*", P()),
    ],
    "model": [
        (r"(\.|\[')(batch_stats|whiten_cache)", P()),
        (r"\['(fc5|fc_out)'\]", P()),
        (r"conv\w*'\]\['kernel'\]", P(None, None, None, MODEL_AXIS)),
        (r"\['fc\w*'\]\['kernel'\]", P(None, MODEL_AXIS)),
        (r".*", P()),
    ],
    "fsdp": [
        (r"(\.|\[')(batch_stats|whiten_cache)", P()),
        (r"conv\w*'\]\['kernel'\]", P(None, None, None, MODEL_AXIS)),
        (r"'\]\['kernel'\]", P(None, MODEL_AXIS)),
        (r".*", P()),
    ],
}


def parse_mesh_shape(text: str) -> Tuple[int, int, int]:
    """``"1,4,2"`` → ``(dcn, data, model)`` sizes; ``"4"`` → ``(1, 4, 1)``,
    ``"2,4"`` → ``(2, 4, 1)`` (JAX's parser)."""
    try:
        parts = [int(p) for p in str(text).split(",")]
    except ValueError:
        raise ValueError(
            f"--mesh_shape {text!r}: expected comma-separated ints "
            f"(dcn,data,model), e.g. 1,4,2"
        ) from None
    if not 1 <= len(parts) <= 3 or any(p < 1 for p in parts):
        raise ValueError(
            f"--mesh_shape {text!r}: need 1-3 positive sizes "
            f"(dcn,data,model)"
        )
    if len(parts) == 1:
        parts = [1, parts[0], 1]
    elif len(parts) == 2:
        parts = [parts[0], parts[1], 1]
    return tuple(parts)  # type: ignore[return-value]


def load_rules_file(path: str) -> List[Rule]:
    """Read a rules table from JSON: ``[[pattern, spec], ...]`` where
    ``spec`` is a list whose entries are ``null`` (unsharded dim), an
    axis name string, or a list of axis names (a dim sharded over
    several axes) — JAX's format, so its rules files run unchanged."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"rules file {path}: expected a JSON list of "
                         "[pattern, spec] pairs")
    rules: List[Rule] = []
    for i, entry in enumerate(raw):
        if not (isinstance(entry, (list, tuple)) and len(entry) == 2):
            raise ValueError(
                f"rules file {path} entry {i}: expected [pattern, spec]"
            )
        pattern, spec = entry
        if not isinstance(spec, list):
            raise ValueError(
                f"rules file {path} entry {i} ({pattern!r}): spec must be "
                "a list of null / axis name / [axis names]"
            )
        dims = []
        for d in spec:
            if d is None or isinstance(d, str):
                dims.append(d)
            elif isinstance(d, list) and all(isinstance(a, str) for a in d):
                dims.append(tuple(d))
            else:
                raise ValueError(
                    f"rules file {path} entry {i} ({pattern!r}): bad spec "
                    f"dim {d!r}"
                )
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"rules file {path} entry {i}: bad regex {pattern!r}: {e}"
            ) from None
        rules.append((pattern, P(*dims)))
    if not rules:
        raise ValueError(f"rules file {path}: empty table")
    return rules


# ------------------------------------------------------------ rule matching


def _rules_table_str(rules: Sequence[Rule]) -> str:
    return "\n".join(
        f"  [{i}] {pat!r} -> {spec}" for i, (pat, spec) in enumerate(rules)
    )


def _axis_sizes(mesh) -> dict:
    return dict(mesh.shape) if mesh is not None else {}


def _validate_spec(
    keypath: str, shape: Tuple[int, ...], spec: P, pattern: str,
    sizes: dict,
) -> None:
    """Fail fast, naming the leaf and the rule, when a spec cannot apply."""
    if len(spec) > len(shape):
        raise ValueError(
            f"sharding rule {pattern!r} assigns {spec} (rank {len(spec)}) "
            f"to leaf {keypath} of shape {shape} (rank {len(shape)})"
        )
    for dim, names in enumerate(spec):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        factor = 1
        for name in names:
            if name not in sizes:
                raise ValueError(
                    f"sharding rule {pattern!r} names mesh axis {name!r} "
                    f"for leaf {keypath}, but the mesh axes are "
                    f"{sorted(sizes)}"
                )
            factor *= sizes[name]
        if shape[dim] % factor:
            hint = ""
            if dim == len(shape) - 1 and re.search(
                r"fc_out|fc5|head", keypath
            ):
                # The one indivisible dim a user hits in practice: a
                # classifier head whose out dim is num_classes (65, ...)
                # under a model-sharding table.  Name the fix.
                hint = (
                    f" — this is a classifier head: pass --pad_classes_to "
                    f"{factor} (model attr pad_classes_to) to pad "
                    f"num_classes up to a multiple of {factor}; padded "
                    "logit columns are sliced out inside the forward, so "
                    "loss/accuracy/serve counters stay exact"
                )
            raise ValueError(
                f"sharding rule {pattern!r} shards dim {dim} of leaf "
                f"{keypath} (shape {shape}) over {names} (size {factor}), "
                f"which does not divide {shape[dim]}{hint}"
            )


# Optimizer-moment containers whose leaves must shard exactly like the
# parameter they update: Adam's mu/nu, SGD's momentum trace.  The param
# twin of ".opt_state[0][1].mu['conv1']['kernel']" is
# ".params['conv1']['kernel']".
_MOMENT_MARKER = re.compile(r"\.(mu|nu|trace)(?=\[|\.|$)")


def _check_moment_alignment(winners: dict, what: str) -> None:
    """Fail fast on param/moment spec skew (the fsdp-table footgun): a
    moment placed unlike its parameter pairs each param block with the
    wrong moment block.  The table is wrong, so the plan refuses it,
    naming BOTH winning rules."""
    for keypath, (pattern, spec) in winners.items():
        m = _MOMENT_MARKER.search(keypath)
        if m is None:
            continue
        suffix = keypath[m.end():]
        twin = None
        for param_path in (".params" + suffix, "['params']" + suffix):
            twin = winners.get(param_path)
            if twin is not None:
                break
        if twin is None:
            continue  # no param twin in this tree (e.g. a pruned subtree)
        p_pattern, p_spec = twin
        if p_spec != spec:
            raise ValueError(
                f"optimizer-moment spec skew in {what}: moment leaf "
                f"{keypath} won rule {pattern!r} -> {spec}, but its "
                f"parameter {param_path} won rule {p_pattern!r} -> "
                f"{p_spec}.  Moments must shard WITH their params — "
                "reorder the table or make the moment-matching rule "
                "assign the param's spec (the presets do this by "
                "matching layer names, not containers)"
            )


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(x, P)


def _tree_items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` of a nest of dicts, lists, tuples and named
    tuples in ``jax.tree_util``'s flatten order and spelling."""
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in _tree_items(
            tree[k], prefix + (f"[{k!r}]" if not isinstance(k, int) else f"[{k}]"))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [it for f in tree._fields for it in _tree_items(getattr(tree, f),
                                                                 f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree) for it in _tree_items(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, specs: Dict[str, P], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], specs, prefix + (
            f"[{k!r}]" if not isinstance(k, int) else f"[{k}]")) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), specs, f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, specs, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return specs[prefix]


class ServeState(NamedTuple):
    """A serving generation's module as the JAX engine's serve state
    ``{"params", "batch_stats", "whiten_cache"}`` (``paths.serve_leaves``),
    for :func:`match_partition_rules`."""

    model: Any


def _leaf_items(tree) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(keystr, JAX-layout shape)`` of every leaf: a serve state's and a
    train state's through ``parallel.paths``, a nest of arrays by its own
    keys."""
    if isinstance(tree, ServeState):
        from dwt_tpu_torch.parallel.paths import serve_leaves

        return [(l.keystr, l.shape) for l in serve_leaves(tree.model)]
    if hasattr(tree, "model"):
        from dwt_tpu_torch.parallel.paths import state_leaves

        layout = getattr(tree.model, "_gspmd_layout", None)
        shapes = layout.full_shapes() if layout is not None else None
        return [(l.keystr, l.shape) for l in state_leaves(
            tree.model, getattr(tree, "optimizer", None), shapes)]
    return [(k, tuple(np.shape(v))) for k, v in _tree_items(tree)]


def match_partition_rules(
    rules: Sequence[Rule],
    tree: Any,
    *,
    mesh=None,
    what: str = "tree",
) -> Any:
    """The :class:`P` of every leaf of ``tree``: a nest of arrays (the
    specs in its structure), a train state or a :class:`ServeState`
    (``{keystr: spec}``).

    Ordered first-match-wins ``re.search`` over each leaf's JAX path (so a
    pattern may anchor with ``^``/``$``).  Scalars and single-element
    leaves are never partitioned.  A leaf matched by NO rule raises with
    its path and the active table; a rule that matches leaves but wins
    none warns with an example and the pattern that won it; with ``mesh``
    every winning spec is shape-validated; an optimizer moment whose spec
    differs from its parameter's raises naming both rules."""
    rules = list(rules)
    sizes = _axis_sizes(mesh)
    matched_any = [False] * len(rules)
    won_any = [False] * len(rules)
    shadow_example: dict = {}
    winners: dict = {}

    def assign(keypath: str, shape: Tuple[int, ...]) -> P:
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        winner = None
        for i, (pattern, spec) in enumerate(rules):
            if re.search(pattern, keypath) is None:
                continue
            matched_any[i] = True
            if winner is None:
                winner = i
                won_any[i] = True
            elif i not in shadow_example:
                shadow_example[i] = (keypath, rules[winner][0])
        if winner is None:
            raise ValueError(
                f"no sharding rule matches {what} leaf {keypath} "
                f"(shape {shape}); active table:\n{_rules_table_str(rules)}"
            )
        pattern, spec = rules[winner]
        if sizes:
            _validate_spec(keypath, shape, spec, pattern, sizes)
        winners[keypath] = (pattern, spec)
        return spec

    specs = {k: assign(k, shape) for k, shape in _leaf_items(tree)}
    for i, (pattern, _) in enumerate(rules):
        if matched_any[i] and not won_any[i]:
            example, winning = shadow_example.get(i, ("?", "?"))
            log.warning(
                "sharding rule %r is fully shadowed: every %s leaf it "
                "matches is claimed by an earlier rule (e.g. %s won by %r)",
                pattern, what, example, winning,
            )
    _check_moment_alignment(winners, what)
    if hasattr(tree, "model"):
        return specs
    return _rebuild(tree, specs)


def _check_duplicate_rules(rules: Sequence[Rule]) -> None:
    seen: dict = {}
    for i, (pattern, spec) in enumerate(rules):
        if pattern in seen:
            log.warning(
                "duplicate sharding rule %r at positions %d and %d; "
                "first-match-wins, so [%d] (-> %s) is dead",
                pattern, seen[pattern], i, i, spec,
            )
        else:
            seen[pattern] = i


# ------------------------------------------------------------------ the plan


class ShardingPlan:
    """One plan: mode, mesh and rules table (module docstring).  Construct
    via :meth:`single`, :meth:`replica`, :meth:`gspmd` or
    :func:`plan_from_config`."""

    def __init__(self, mode: str, mesh=None, rules: Optional[List[Rule]] = None,
                 *, name: str = "dp"):
        if mode not in ("single", "replica", "gspmd"):
            raise ValueError(f"unknown plan mode {mode!r}")
        if mode != "single" and mesh is None:
            raise ValueError(f"{mode} plan needs a mesh")
        if mode == "single" and mesh is not None:
            raise ValueError("a single plan has no mesh")
        if mode == "gspmd" and not isinstance(mesh, PlanMesh):
            raise ValueError("a gspmd plan needs a (dcn, data, model) PlanMesh")
        self.mode = mode
        self.mesh = mesh
        self.rules = list(rules) if rules else list(PRESETS["dp"])
        self.name = name
        if mode == "single":
            self.data_axes: Tuple[str, ...] = ()
        else:
            # replica: the batch flattens over EVERY mesh axis; gspmd: over
            # every axis except model.
            self.data_axes = tuple(a for a in mesh.axis_names
                                   if mode == "replica" or a != MODEL_AXIS)
        _check_duplicate_rules(self.rules)

    @classmethod
    def single(cls) -> "ShardingPlan":
        return cls("single")

    @classmethod
    def replica(cls, mesh: Mesh) -> "ShardingPlan":
        return cls("replica", mesh)

    @classmethod
    def from_mesh(cls, mesh: Optional[Mesh]) -> "ShardingPlan":
        return cls.single() if mesh is None else cls.replica(mesh)

    @classmethod
    def gspmd(cls, mesh: PlanMesh, rules: Sequence[Rule],
              name: str = "custom") -> "ShardingPlan":
        """A rules-engine plan over the ``(dcn, data, model)`` mesh."""
        return cls("gspmd", mesh, list(rules), name=name)

    # ---------------------------------------------------------- properties

    @property
    def group(self):
        """The group the model's norm sites and the steps reduce over: the
        mesh (replica), the data group (gspmd) or None (single) — JAX's
        ``axis_name``."""
        if self.mode == "gspmd":
            return self.mesh.data_group
        return self.mesh

    @property
    def data_size(self) -> int:
        """The number of batch shards (1 in single mode)."""
        if self.mode == "single":
            return 1
        sizes = _axis_sizes(self.mesh)
        return int(np.prod([sizes[a] for a in self.data_axes] or [1]))

    @property
    def batch_shard(self) -> Optional[Tuple[int, int]]:
        """``(this rank's batch shard, the shard count)``; None in single
        mode.  Under gspmd the shard is the rank's batch position: the
        ranks of one model group load the same rows."""
        if self.mode == "single":
            return None
        if self.mode == "gspmd":
            return self.mesh.batch_position, self.mesh.data_size
        return self.mesh.index, self.mesh.size

    @property
    def uses_model_axis(self) -> bool:
        """True when any rule can place a leaf on MODEL_AXIS."""
        return self._any_rule_on(lambda name, size: name == MODEL_AXIS and size > 1)

    @property
    def uses_state_sharding(self) -> bool:
        """True when any rule can shard a state leaf over ANY axis of size
        > 1: the plans whose saves gather and whose restores go to spec."""
        return self._any_rule_on(lambda name, size: size > 1)

    def _any_rule_on(self, pred) -> bool:
        if self.mode != "gspmd":
            return False
        sizes = _axis_sizes(self.mesh)
        for _, spec in self.rules:
            for names in spec:
                names = names if isinstance(names, tuple) else (names,)
                if any(pred(n, sizes.get(n, 1)) for n in names):
                    return True
        return False

    @property
    def capture(self) -> bool:
        """May a chunk's steps be captured as a CUDA graph?  Always in
        single mode; in replica mode when the mesh's collectives can be
        (NCCL); never in gspmd mode (module docstring)."""
        if self.mode == "gspmd":
            return False
        return self.mesh is None or self.mesh.capturable

    def describe(self) -> str:
        if self.mode == "single":
            return "single"
        if self.mode == "replica":
            return f"replica dp over {dict(self.mesh.shape)} ({self.mesh.backend})"
        return (f"gspmd {self.name} over {dict(self.mesh.shape)} "
                f"({self.mesh.backend})")

    # -------------------------------------------------------------- specs

    def batch_spec(self, chunked: bool = False) -> P:
        """Batch leaves shard their sample axis over the data axes (the
        SECOND axis for ``[k, batch, ...]`` chunks)."""
        axes = self.data_axes if len(self.data_axes) != 1 else self.data_axes[0]
        return P(None, axes) if chunked else P(axes)

    def tree_specs(self, tree: Any, what: str = "tree") -> Any:
        """Per-leaf :class:`P` from the rules table, validated against the
        mesh (:func:`match_partition_rules`)."""
        return match_partition_rules(self.rules, tree, mesh=self.mesh, what=what)

    def _layout(self, state, what: str = "train state"):
        """The gspmd layout of ``state`` (made at its first placement,
        from the whole tensors' shapes)."""
        from dwt_tpu_torch.parallel import gspmd
        from dwt_tpu_torch.parallel.paths import state_leaves

        layout = gspmd.layout_of(state.model)
        if layout is not None:
            return layout
        specs = self.tree_specs(state, what=what)
        leaves = [l for l in state_leaves(state.model, state.optimizer) if l.opt_key is None]
        return gspmd.Layout(self.mesh, self._leaf_layouts(leaves, specs))

    def _leaf_layouts(self, leaves, specs) -> Dict[str, Any]:
        """``{name: gspmd.LeafLayout}`` of ``paths`` leaves under ``specs``."""
        from dwt_tpu_torch.parallel import gspmd

        out = {}
        for leaf in leaves:
            full = tuple(leaf.shape) if leaf.perm is None else tuple(
                leaf.shape[j] for j in leaf.perm)
            spec = gspmd.torch_spec(specs[leaf.keystr], len(full), leaf.perm)
            out[leaf.name] = gspmd.LeafLayout(
                leaf.name, leaf.keystr, specs[leaf.keystr], spec, full,
                gspmd.block_slices(spec, full, self.mesh.coords, _axis_sizes(self.mesh)))
        return out

    def serve_layout(self, model):
        """The gspmd layout of a serving generation of ``model`` (whole
        tensors): its serve state's specs, validated against the mesh."""
        from dwt_tpu_torch.parallel import gspmd
        from dwt_tpu_torch.parallel.paths import serve_leaves

        specs = self.tree_specs(ServeState(model), what="serve state")
        return gspmd.Layout(self.mesh, self._leaf_layouts(serve_leaves(model), specs))

    def restore_shardings(self, template: Any, what: str = "state"):
        """The restore-to-spec target of a checkpoint restore (the placed
        state's layout), or None on the single and replica paths, whose
        restore stays byte for byte as it was."""
        if self.mode != "gspmd":
            return None
        from dwt_tpu_torch.parallel import gspmd

        layout = gspmd.layout_of(template.model)
        if layout is None:
            raise ValueError("restore to spec needs the state placed first (plan.place)")
        return layout

    # ---------------------------------------------------------- placement

    def place(self, state, what: str = "train state"):
        """Place ``state`` (a ``TrainState``) onto its plan shardings
        (gspmd; span ``shard_put``), else identity.  A state not yet
        placed is first made rank 0's on every rank (as
        :meth:`place_replicated`), then each sharded parameter and its
        moments cut to this rank's block; a placed one is checked, and
        left as it is."""
        if self.mode != "gspmd":
            return state
        from dwt_tpu_torch.parallel import dp, gspmd

        with obs.span("shard_put", "shard"):
            layout = gspmd.layout_of(state.model)
            if layout is not None:
                layout.check_placed(state.model)
                return state
            layout = self._layout(state, what)
            dp.replicate_state(state, self.mesh.world_group)
            layout.place(state.model, state.optimizer)
            state.model._gspmd_layout = layout
        return state

    def place_serve(self, model):
        """Place a serving generation's module (gspmd; span ``shard_put``),
        else identity: each sharded parameter cut to this rank's block on
        the host, where the module still is, and the gathering hooks
        installed, so only blocks reach the device — the serving restore
        to spec (``dwt_tpu.serve.engine``'s loose restore plus plan
        placement).  The stats and eval matrices stay whole."""
        if self.mode != "gspmd":
            return model
        from dwt_tpu_torch.parallel import gspmd

        with obs.span("shard_put", "shard"):
            if gspmd.layout_of(model) is None:
                layout = self.serve_layout(model)
                layout.place(model)
                model._gspmd_layout = layout
        return model

    def place_replicated(self, state):
        """Make every rank's state rank 0's (replica mode), else identity:
        the gspmd mode places with :meth:`place`."""
        if self.mode != "replica":
            return state
        from dwt_tpu_torch.parallel import dp

        return dp.replicate_state(state, self.mesh)

    def gather(self, state):
        """The whole state as a host ``HostState`` (gspmd; span
        ``gather``): every sharded leaf all-gathered, so a save's bytes
        do not depend on the plan.  Identity in the other modes."""
        if self.mode != "gspmd":
            return state
        from dwt_tpu_torch.parallel import gspmd
        from dwt_tpu_torch.utils.checkpoint import HostState

        layout = gspmd.layout_of(state.model)
        with obs.span("gather", "shard"):
            payload = layout.gather_state(state)
        return HostState(payload, tuple(n for n, _ in state.model.named_parameters()))

    def shard_fns(self, state, what: str = "train state") -> Dict[str, Callable]:
        """Per-leaf placement callables: each cuts a whole tensor of its
        state-dict key down to this rank's block (identity where the key's
        spec shards nothing or outside gspmd)."""
        if self.mode != "gspmd":
            return {k: (lambda t: t) for k in state.model.state_dict()}
        layout = self._layout(state, what)
        return {k: (lambda t, _l=l: t[_l.block] if _l.sharded else t)
                for k, l in layout.leaves.items()}

    def gather_fns(self, state) -> Dict[str, Callable]:
        """Per-leaf gather callables: each returns its key's whole tensor
        from this rank's block (a collective where the spec shards)."""
        if self.mode != "gspmd":
            return {k: (lambda t: t) for k in state.model.state_dict()}
        from dwt_tpu_torch.parallel import gspmd

        layout = gspmd.layout_of(state.model) or self._layout(state)
        return {k: (lambda t, _l=l: layout.gather_block(_l, t) if _l.sharded else t)
                for k, l in layout.leaves.items()}

    def shard_batch(self, batch: Any, chunked: bool = False) -> Any:
        """This rank's slice of a host batch (identity in single mode)."""
        if self.mode == "single":
            return batch
        from dwt_tpu_torch.parallel import dp

        index, count = self.batch_shard
        return dp.slice_batch(batch, index, count, chunked)

    # ----------------------------------------------------------- serving

    def serve_positions(self) -> List[int]:
        """Each rank's batch position (its block of a bucket), by rank:
        the replica mesh's flattened order, the gspmd ``(dcn, data)``
        position (the ranks of one model group share theirs)."""
        if self.mode == "single":
            return [0]
        ranks = [int(r) for r in self.mesh.ranks.reshape(-1)]
        if self.mode == "replica":
            return [ranks.index(r) for r in range(len(ranks))]
        shape = self.mesh.ranks.shape
        coords = [np.unravel_index(ranks.index(r), shape) for r in range(len(ranks))]
        return [int(c[0]) * shape[1] + int(c[1]) for c in coords]

    def serve_split(self, x) -> List[Any]:
        """A bucket's rows (its leading axis a multiple of the data size)
        as one block per rank, by rank (:meth:`serve_positions`)."""
        from dwt_tpu_torch.parallel import dp

        count = self.data_size
        return [dp.slice_batch(x, p, count) for p in self.serve_positions()]

    def serve_join(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ranks' logits blocks (by rank) as the bucket's: the first
        rank's block of each batch position, in position order."""
        first: Dict[int, torch.Tensor] = {}
        for p, b in zip(self.serve_positions(), blocks):
            first.setdefault(p, b)
        return torch.cat([first[p] for p in range(self.data_size)])

    def make_serve_forward(self, forward: Callable) -> Callable:
        """The serving fan-out's per-rank body ``(model, x block) ->
        logits block``: the replica mode's collective-free per-sample
        forward (``dp.make_sharded_serve_forward``); gspmd and single the
        forward itself — under gspmd the placed module's hooks gather its
        blocks over the model group."""
        if self.mode == "replica":
            from dwt_tpu_torch.parallel import dp

            return dp.make_sharded_serve_forward(forward, self.mesh)
        return forward

    # ------------------------------------------------------ step factories

    def _check_step(self, fn: Callable, what: str) -> Callable:
        from dwt_tpu_torch.parallel import dp

        return dp._check_group(fn, self.group, what)

    def make_train_step(self, raw_step: Callable) -> Callable:
        if self.mode == "single":
            return raw_step
        if self.mode == "gspmd":
            return self._check_step(raw_step, "train step")
        from dwt_tpu_torch.parallel import dp

        return dp.make_sharded_train_step(raw_step, self.mesh)

    def make_scanned_step(self, raw_step: Callable, k: int) -> Callable:
        from dwt_tpu_torch.parallel import dp
        from dwt_tpu_torch.train.steps import make_scanned_step

        if self.mode == "single":
            return make_scanned_step(raw_step, k)
        if self.mode == "gspmd":
            self._check_step(raw_step, "train step")
            scanned = make_scanned_step(raw_step, k, capture=False)
            scanned.group = self.group
            return scanned
        return dp.make_sharded_scanned_step(raw_step, self.mesh, k)

    def make_eval_step(self, accum_eval: Callable) -> Callable:
        if self.mode == "single":
            return accum_eval
        if self.mode == "gspmd":
            return self._check_step(accum_eval, "eval step")
        from dwt_tpu_torch.parallel import dp

        return dp.make_sharded_eval_step(accum_eval, self.mesh)

    def make_collect_step(self, scanned_collect: Callable) -> Callable:
        if self.mode == "single":
            return scanned_collect
        if self.mode == "gspmd":
            return self._check_step(scanned_collect, "stat-collection step")
        from dwt_tpu_torch.parallel import dp

        return dp.make_sharded_collect_step(scanned_collect, self.mesh)


# ------------------------------------------------------------- construction


def _preset_or_file(spec: str) -> Tuple[List[Rule], str]:
    if spec in PRESETS:
        return list(PRESETS[spec]), spec
    return load_rules_file(spec), spec


def _local_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def plan_from_flags(
    *,
    mesh_shape: Optional[str] = None,
    sharding_rules: str = "dp",
    data_parallel: bool = False,
    dcn_slices: int = 0,
    batch_size: Optional[int] = None,
    batch_size_flag: str = "--source_batch_size",
    pallas_whiten: bool = False,
    distributed: bool = False,
    world_size: Optional[int] = None,
    local_devices: Optional[int] = None,
) -> ShardingPlan:
    """Resolve the CLI surface into a plan (module docstring).
    ``world_size`` defaults to the process group's size (1 without one);
    ``local_devices`` to the GPUs this host shows (0 for a CPU run)."""
    sharding_rules = sharding_rules or "dp"
    dcn = int(dcn_slices or 0)
    world = process_count() if world_size is None else int(world_size)
    legacy = mesh_shape is None and sharding_rules == "dp"
    if pallas_whiten and (data_parallel or not legacy):
        raise ValueError(
            "--pallas_whiten is single-chip (no cross-replica moment "
            "pmean); drop it or the sharding flags"
        )
    if data_parallel and not distributed and world == 1:
        gpus = _local_gpus() if local_devices is None else int(local_devices)
        if gpus > 1:
            raise ValueError(
                f"--data_parallel without --distributed on a host with {gpus} "
                "GPUs: the port runs one process per device — launch one "
                "process per GPU with --distributed (torchrun, or the DWT_* "
                "variables); a single process would train on one of them")
    if legacy:
        if not data_parallel or world == 1:
            if dcn > 1:
                raise ValueError(
                    "--dcn_slices > 1 requires --data_parallel and more "
                    "than one device — the 2-D (dcn, data) mesh only "
                    "exists on the sharded path"
                )
            return ShardingPlan.single()
        if batch_size is not None and batch_size % world != 0:
            raise ValueError(
                f"--data_parallel shards the per-domain batch over "
                f"{world} devices, so {batch_size_flag} "
                f"must be divisible by it; got {batch_size}"
            )
        return ShardingPlan.replica(make_mesh(
            list(range(world)), dcn_slices=dcn if dcn > 1 else None))

    rules, name = _preset_or_file(sharding_rules)
    if data_parallel and name != "dp":
        # --data_parallel promises the replica program, a non-dp rules
        # table routes through gspmd: silently dropping either promise
        # would be a numerics change the user never sees.
        raise ValueError(
            "--data_parallel conflicts with --sharding_rules "
            f"{sharding_rules!r}: the rules table owns placement on the "
            "gspmd path — drop --data_parallel (the table's data axis "
            "already shards the batch) or use the dp rules"
        )
    shape = (1, world, 1) if mesh_shape is None else parse_mesh_shape(mesh_shape)
    if dcn > 1 and shape[0] != dcn:
        raise ValueError(
            f"--dcn_slices {dcn} conflicts with --mesh_shape dcn axis "
            f"{shape[0]}; pass the dcn size in --mesh_shape alone"
        )
    if name != "dp":
        plan = ShardingPlan.gspmd(_whole_mesh(shape, mesh_shape, world), rules, name=name)
        if not plan.uses_state_sharding:
            # dp rules + a model axis raise below, so model rules on a mesh
            # where every shardable axis has size 1 must at least warn: the
            # run would execute fully replicated while the flags claim
            # model sharding.
            log.warning(
                "--sharding_rules %s over mesh %s shards NOTHING (every "
                "axis its rules name has size 1) — running fully "
                "replicated; pass a model axis in --mesh_shape (e.g. "
                "1,%d,2) to actually shard",
                name, shape, max(1, shape[1] // 2),
            )
        return _check_batch(plan, batch_size, batch_size_flag)
    if shape[2] > 1:
        raise ValueError(
            "--sharding_rules dp replicates every state leaf; a model "
            f"axis of {shape[2]} would do nothing but waste chips — "
            "pass a model-sharding rules table (preset 'model', "
            "preset 'fsdp', or a rules file)"
        )
    need = shape[0] * shape[1]
    if need > world:
        raise ValueError(
            f"--mesh_shape {mesh_shape!r} needs {need} devices; only "
            f"{world} available"
        )
    _check_covers(need, world, mesh_shape)
    plan = ShardingPlan.replica(make_mesh(
        list(range(need)), dcn_slices=shape[0] if shape[0] > 1 else None))
    return _check_batch(plan, batch_size, batch_size_flag)


def _check_covers(need: int, world: int, mesh_shape) -> None:
    if need < world:
        raise ValueError(
            f"--mesh_shape {mesh_shape!r} covers {need} ranks of the group's "
            f"{world}: every rank must be in the mesh (one outside it would "
            "train alone) — launch as many processes as the mesh has positions")


def _whole_mesh(shape, mesh_shape, world: int) -> PlanMesh:
    """The plan mesh of ``shape``; it must hold every rank of the group."""
    mesh = make_plan_mesh(shape, world)
    _check_covers(mesh.size, world, mesh_shape)
    return mesh


def _check_batch(plan: ShardingPlan, batch_size, batch_size_flag: str) -> ShardingPlan:
    if batch_size is not None and batch_size % plan.data_size != 0:
        raise ValueError(
            f"the plan shards the per-domain batch over {plan.data_size} "
            f"data-axis shards, so {batch_size_flag} must be divisible "
            f"by it; got {batch_size}"
        )
    return plan


def plan_from_config(cfg) -> ShardingPlan:
    """The training loops' entry: one plan from a Digits/OfficeHome
    config."""
    return plan_from_flags(
        mesh_shape=getattr(cfg, "mesh_shape", None),
        sharding_rules=getattr(cfg, "sharding_rules", "dp"),
        data_parallel=getattr(cfg, "data_parallel", False),
        dcn_slices=getattr(cfg, "dcn_slices", 0) or 0,
        batch_size=getattr(cfg, "source_batch_size", None),
        pallas_whiten=getattr(cfg, "pallas_whiten", False),
        distributed=getattr(cfg, "distributed", False),
        local_devices=0 if getattr(cfg, "device", "cuda") == "cpu" else None,
    )


def sharding_requested(cfg) -> bool:
    """Does this config ask for sharded execution?  (The multi-process
    data split's gate: without a sharded step there is no gradient sync.)"""
    return bool(
        getattr(cfg, "data_parallel", False)
        or getattr(cfg, "mesh_shape", None)
        or (getattr(cfg, "sharding_rules", "dp") or "dp") != "dp"
    )
