"""Sharded train state across processes — the port's stand-in for XLA's SPMD partitioner.

Under the gspmd mode of the sharding plan (``parallel.plan``), each leaf
of the train state has a spec from the rules table.  The JAX package
places each leaf with ``NamedSharding(mesh, spec)`` and lets XLA insert the
communication; here every rank is a process, and :class:`Layout` does it:

* **Storage.** A sharded tensor is held on each rank as its block only:
  the block that ``NamedSharding(mesh, spec).devices_indices_map(shape)``
  gives the device at the rank's mesh position, mapped through the leaf's
  layout map (``parallel.paths``; a dim sharded over several axes is split
  over them major to minor).  :meth:`Layout.place` replaces each sharded
  parameter by a parameter of its block (the optimizer's references and
  moments with it), keeping its memory format; the running statistics and
  every leaf whose spec shards nothing stay whole on every rank.
* **Forward.** A forward pre-hook gathers a module's sharded parameters
  over the axes their specs name (all-gathers over lines of the mesh,
  innermost axis first) and shows the module the full tensors for that
  forward; a forward hook drops them (the autograd graph keeps what the
  backward needs).
* **Backward.** The ranks of one model group see the same rows and the
  same full weights, so they compute the same full gradient; the gather's
  backward keeps this rank's block of it, with no communication.  The
  gradients are then averaged over the data group (the batch's shards).
  A leaf whose spec names a batch axis (``dcn`` or ``data``) is the
  exception: the ranks of its data group hold different blocks, so its
  full gradient is averaged over the data group before the block is kept
  (JAX's reduce-scatter), and it is left out of the later mean.
  A leaf whose spec shards nothing is averaged over the model group too,
  an identity where that group's ranks agree bitwise (the CPU tests show
  they do) that keeps the replicas of such a leaf equal where the card's
  backward algorithms are not deterministic.
* **Optimizer.** SGD's momentum and Adam's moments are elementwise, so
  they act on the blocks exactly.
* **Whole-tensor quantities** are the gathered tensors': the gradient norm
  (:meth:`Layout.grad_norm`, a sum of squares over the world weighted by
  each block's copies), the parameters' digests
  (:meth:`Layout.full_named_parameters`) and every save
  (:meth:`Layout.gather_state`, a host copy leaf by leaf).
* **Restore to spec.** :meth:`Layout.host_blocks` cuts a checkpoint's host
  payload down to this rank's blocks, so a restore moves only blocks to
  the device (``utils.checkpoint``).
* **Serving.** A serving generation's eval module takes the same layout
  without an optimizer (``ShardingPlan.serve_layout``, over the serve
  state's paths): :meth:`Layout.place` on the host module, then the move
  to the device; its forwards run under ``torch.inference_mode``, where
  the pre-hooks gather the blocks as in training and nothing records a
  backward.

Imports torch only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from dwt_tpu_torch.parallel.mesh import MODEL_AXIS, PlanMesh

Spec = Tuple[Optional[Tuple[str, ...]], ...]  # per torch dim: the axes, or None


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One state-dict entry's placement: its JAX path and spec, the spec
    in torch dims, the full shape (torch layout) and this rank's block."""

    name: str
    keystr: str
    jax_spec: Tuple
    spec: Spec
    full_shape: Tuple[int, ...]
    block: Tuple[slice, ...]

    @property
    def sharded(self) -> bool:
        return any(a is not None for a in self.spec)

    @property
    def batch_sharded(self) -> bool:
        """Whether the spec names a batch axis: the ranks of one data
        group then hold different blocks of this leaf."""
        return any(a != MODEL_AXIS for axes in self.spec for a in axes or ())


def _axes(names) -> Optional[Tuple[str, ...]]:
    if names is None:
        return None
    return tuple(names) if isinstance(names, tuple) else (names,)


def torch_spec(jax_spec: Sequence, ndim: int, perm: Optional[Sequence[int]]) -> Spec:
    """A spec over JAX dims as one over the port's dims (``perm`` as
    ``paths.StateLeaf.perm``); trailing dims the spec leaves out are whole."""
    dims = [_axes(jax_spec[j]) if j < len(jax_spec) else None for j in range(ndim)]
    if perm is None:
        return tuple(dims)
    return tuple(dims[perm[t]] for t in range(ndim))


def block_slices(spec: Spec, shape: Sequence[int], coords: Sequence[int],
                 sizes: Dict[str, int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` under ``spec`` held at mesh
    position ``coords`` (``(dcn, data, model)``): a dim over axes ``(a,
    b)`` splits into ``|a|·|b|`` chunks, chunk ``i_a·|b| + i_b``."""
    from dwt_tpu_torch.parallel.mesh import PLAN_AXES

    pos = dict(zip(PLAN_AXES, coords))
    out = []
    for axes, n in zip(spec, shape):
        if axes is None:
            out.append(slice(None))
            continue
        index, count = 0, 1
        for a in axes:
            index = index * sizes[a] + pos[a]
            count *= sizes[a]
        size = int(n) // count
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def _layout_copy(view: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``view`` as a tensor of its own, in ``like``'s memory format."""
    fmt = (torch.channels_last if like.dim() == 4
           and like.is_contiguous(memory_format=torch.channels_last)
           and not like.is_contiguous() else torch.contiguous_format)
    return torch.empty(view.shape, dtype=view.dtype, device=view.device,
                       memory_format=fmt).copy_(view)


class _Gathered(torch.autograd.Function):
    """The full tensor of a block (forward: all-gathers); backward keeps
    this rank's block of the full gradient, averaged first over the data
    group where the leaf's spec names a batch axis."""

    @staticmethod
    def forward(ctx, block, layout: "Layout", leaf: LeafLayout):
        ctx.leaf, ctx.group = leaf, layout.mesh.data_group
        return layout.gather_block(leaf, block)

    @staticmethod
    def backward(ctx, grad):
        if ctx.leaf.batch_sharded and ctx.group.size > 1:
            grad = grad.clone(memory_format=torch.contiguous_format)
            ctx.group.psum_(grad)
            grad /= ctx.group.size
        return grad[ctx.leaf.block].contiguous(), None, None


def _split(name: str) -> Tuple[str, str]:
    head, _, attr = name.rpartition(".")
    return head, attr


class Layout:
    """The placement of one model's (and its optimizer's) state over a
    :class:`PlanMesh` (module docstring).  ``leaves`` maps every model
    state-dict key to its :class:`LeafLayout`."""

    def __init__(self, mesh: PlanMesh, leaves: Dict[str, LeafLayout]):
        self.mesh = mesh
        self.leaves = leaves
        self.sizes = dict(mesh.shape)

    # -------------------------------------------------------------- blocks

    def sharded(self) -> List[LeafLayout]:
        return [l for l in self.leaves.values() if l.sharded]

    def copies(self, leaf: LeafLayout) -> int:
        """How many ranks hold each block of ``leaf``."""
        n = self.mesh.size
        for axes in leaf.spec:
            for a in axes or ():
                n //= self.sizes[a]
        return n

    def block_shape(self, leaf: LeafLayout) -> Tuple[int, ...]:
        return tuple(len(range(*s.indices(n))) for s, n in zip(leaf.block, leaf.full_shape))

    def gather_block(self, leaf: LeafLayout, block: torch.Tensor) -> torch.Tensor:
        """The full tensor of ``leaf`` from every rank's ``block``, in the
        block's memory format (a collective over the lines of the axes its
        spec names)."""
        full = block.detach().contiguous()
        for dim, axes in enumerate(leaf.spec):
            for a in reversed(axes or ()):
                full = torch.cat(self.mesh.line(a).all_gather(full), dim=dim)
        return _layout_copy(full, block) if full.dim() == 4 else full

    # ----------------------------------------------------------- placement

    def place(self, model: nn.Module, optimizer=None) -> None:
        """Replace every sharded parameter of ``model`` by a parameter of
        its block (in the optimizer's groups and state too) and install
        the gathering hooks.  The tensors must be whole."""
        by_module: Dict[str, List[str]] = {}
        with torch.no_grad():
            for leaf in self.sharded():
                head, attr = _split(leaf.name)
                module = model.get_submodule(head)
                old = module._parameters.get(attr)
                if old is None:
                    raise ValueError(
                        f"sharding rule for {leaf.keystr} ({leaf.jax_spec}) shards a "
                        "running statistic or an eval matrix: the port's norm sites "
                        "update their stats in place and read their eval matrices "
                        "whole, so a rules table must keep batch_stats and "
                        "whiten_cache replicated")
                if tuple(old.shape) != leaf.full_shape:
                    raise ValueError(f"{leaf.name}: shape {tuple(old.shape)} is not the "
                                     f"planned {leaf.full_shape}")
                new = nn.Parameter(_layout_copy(old[leaf.block], old),
                                   requires_grad=old.requires_grad)
                _check_dtype(old, new)
                module._parameters[attr] = new
                if optimizer is not None:
                    _swap_param(optimizer, old, new, leaf.block)
                by_module.setdefault(head, []).append(attr)
        for head, attrs in by_module.items():
            module = model.get_submodule(head)
            leaves = [self.leaves[f"{head}.{a}" if head else a] for a in attrs]
            module.register_forward_pre_hook(self._pre_hook(attrs, leaves))
            module.register_forward_hook(self._post_hook(attrs))

    def _pre_hook(self, attrs: List[str], leaves: List[LeafLayout]):
        layout = self

        def hook(module, args):
            for attr, leaf in zip(attrs, leaves):
                module.__dict__[attr] = _Gathered.apply(module._parameters[attr], layout, leaf)
        return hook

    @staticmethod
    def _post_hook(attrs: List[str]):
        def hook(module, args, output):
            for attr in attrs:
                module.__dict__.pop(attr, None)
        return hook

    def check_placed(self, model: nn.Module) -> None:
        """Raise unless every sharded parameter of ``model`` holds its
        block (no tensor of the state may leave its placement)."""
        params = dict(model.named_parameters())
        for leaf in self.sharded():
            got = tuple(params[leaf.name].shape)
            if got != self.block_shape(leaf):
                raise RuntimeError(f"{leaf.name} left its placement: shape {got}, "
                                   f"block {self.block_shape(leaf)}")

    # ----------------------------------------------------------- gradients

    def param_leaves(self, model: nn.Module) -> List[Tuple[nn.Parameter, LeafLayout]]:
        return [(p, self.leaves[n]) for n, p in model.named_parameters()]

    def mean_grads(self, model: nn.Module, group) -> None:
        """Every gradient averaged over the data ``group``, in place, but
        those of batch-sharded leaves (averaged in the backward); those of
        the leaves whose spec shards nothing also over the model group
        (the module docstring)."""
        from dwt_tpu_torch.train.steps import _mean_grads

        pairs = [(p.grad, l) for p, l in self.param_leaves(model) if p.grad is not None]
        grads = [g for g, l in pairs if not l.batch_sharded]
        if group is not None and group.size > 1:
            _mean_grads(grads, group)
        whole = [g for g, l in pairs if not l.sharded]
        if whole and self.mesh.model_group.size > 1:
            _mean_grads(whole, self.mesh.model_group)

    def grad_norm(self, model: nn.Module) -> torch.Tensor:
        """The global gradient norm of the gathered gradients: each
        block's squared norm over the world, divided by its copies."""
        terms = []
        for p, leaf in self.param_leaves(model):
            if p.grad is not None:
                n = torch.linalg.vector_norm(p.grad).double()
                terms.append(n * n / self.copies(leaf))
        total = torch.stack(terms).sum()
        self.mesh.world_group.psum_(total)
        return total.sqrt().float()

    # ------------------------------------------------------ whole tensors

    def full_named_parameters(self, model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
        """``model.named_parameters()`` with each sharded block gathered."""
        return [(n, self.gather_block(self.leaves[n], p) if self.leaves[n].sharded else p)
                for n, p in model.named_parameters()]

    def _param_names(self, model: nn.Module, optimizer) -> List[str]:
        names = {id(p): n for n, p in model.named_parameters()}
        return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def gather_state(self, state):
        """The ``TrainState.state_dict()`` payload of the gathered state,
        every tensor a contiguous host copy (gathered leaf by leaf, so the
        device holds one full tensor at a time)."""
        from dwt_tpu_torch.train.state import _host_copy, _host_tensor

        live = state._live()
        model = {k: _host_tensor(self.gather_block(self.leaves[k], v)
                                 if k in self.leaves and self.leaves[k].sharded else v)
                 for k, v in live["model"].items()}
        names = self._param_names(state.model, state.optimizer)
        opt_state = {}
        for i, buffers in live["optimizer"]["state"].items():
            leaf = self.leaves[names[int(i)]]
            block = self.block_shape(leaf)
            opt_state[i] = {
                k: (_host_tensor(self.gather_block(leaf, v)) if torch.is_tensor(v)
                    and leaf.sharded and tuple(v.shape) == block else _host_copy(v))
                for k, v in buffers.items()}
        optimizer = {**_host_copy({k: v for k, v in live["optimizer"].items() if k != "state"}),
                     "state": opt_state}
        return {"model": model, "optimizer": optimizer, "step": int(state.step),
                "lr_scale": float(state.lr_scale)}

    # ---------------------------------------------------- restore to spec

    def full_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {k: l.full_shape for k, l in self.leaves.items()}

    def host_blocks(self, payload: dict, state) -> dict:
        """A whole host payload (``TrainState.state_dict()`` form) cut down
        to this rank's blocks: views of the host arrays, nothing on the
        device."""
        model = {k: (v[self.leaves[k].block] if k in self.leaves and self.leaves[k].sharded
                     else v) for k, v in payload["model"].items()}
        names = self._param_names(state.model, state.optimizer)
        opt_state = {}
        for i, buffers in payload["optimizer"]["state"].items():
            leaf = self.leaves[names[int(i)]]
            opt_state[i] = {
                k: (v[leaf.block] if torch.is_tensor(v) and leaf.sharded
                    and tuple(v.shape) == leaf.full_shape else v)
                for k, v in buffers.items()}
        return {**payload, "model": model,
                "optimizer": {**payload["optimizer"], "state": opt_state}}


def _check_dtype(leaf: torch.Tensor, placed: torch.Tensor) -> None:
    """Placement must keep every leaf's dtype (``ShardingPlan._check_dtype``)."""
    if leaf.dtype != placed.dtype:
        raise TypeError(
            f"plan placement changed a leaf's dtype {leaf.dtype} -> {placed.dtype} "
            "— placement must preserve reduced-precision leaves "
            "(bf16 cache, int8 weights), never silently upcast")


def _swap_param(optimizer, old: nn.Parameter, new: nn.Parameter,
                block: Tuple[slice, ...]) -> None:
    for group in optimizer.param_groups:
        group["params"] = [new if p is old else p for p in group["params"]]
    saved = optimizer.state.pop(old, None)
    if saved:
        optimizer.state[new] = {
            k: (_layout_copy(v[block], v) if torch.is_tensor(v) and v.shape == old.shape
                else v) for k, v in saved.items()}


def layout_of(model: nn.Module) -> Optional[Layout]:
    """The :class:`Layout` a gspmd plan placed ``model`` with (None)."""
    return getattr(model, "_gspmd_layout", None)
