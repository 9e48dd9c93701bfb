"""Bucketed inference engine: the deployment forward, one immutable generation at a time.

The port of ``dwt_tpu.serve.engine``.  The deployment artifact is the
target-branch eval forward — frozen running stats, domain-specific
whitening at test time:

* **whiten once per generation**: every site's eval whitening matrix is
  factorized from the frozen stats in one batched call (:func:`dwt_tpu_
  torch.train.evalpipe.make_whiten_cache`, which the eval pipeline uses
  too) and installed into the sites (the counterpart of
  ``dwt_tpu.train.steps.eval_variables``);
* **device-resident**: a generation's weights, stats and cache are placed
  on the device once; per request only the bucket batch moves (H2D from
  pinned memory) and the logits come back;
* **warm once per bucket**: one forward per bucket shape at construction
  (the counterpart of the JAX engine's AOT compile), so the first
  request of any size pays no first-call set-up;
* the forward itself is ``model(x)`` in eval mode under
  ``torch.inference_mode`` — ``dwt_tpu.train.steps.make_serve_forward``;
  the model's compute dtype is the serving dtype (``--serve_dtype``): a
  bf16 model computes in bf16 from f32 parameters, its whiten cache is
  factorized in f32 and then rounded to bf16 once (the JAX engine's
  ``cache_dtype`` cast), and the logits come back as f32;
* **from a checkpoint**: :meth:`ServeEngine.from_checkpoint` restores the
  parameters and stats of the newest valid step (main directory and
  anchors) without an optimizer — a checkpoint the port trained, or one
  the JAX package wrote in its host-shard or delta format — and records
  its ``step``, ``source`` and parameter digest.

**Generations and hot swap** (the deploy pipeline, ``dwt_tpu_torch.
fleet``).  An :class:`EngineState` is one generation: its own eval-mode
module, whose parameters, stat buffers and installed eval matrices
belong to it alone, and the named views of them (``params``,
``batch_stats``, ``cache``, ``scales``) with the :class:`Version`.  The
port installs eval matrices as module attributes, so a swap that
re-installed a cache or loaded a state dict into one live module would
change weights under a running forward; instead every build makes a new
module (an adapted generation shares its base's parameter tensors, which
nothing writes) and :meth:`ServeEngine.swap` is a single reference
assignment.  The dispatcher snapshots ``engine.state`` once per batch
and runs that generation's module, so a batch never mixes generations.
Builds run on the caller's thread — the reloader's or the adapter's —
while the dispatcher keeps serving.

**Int8** (``quantize=True``, ``--quantize_int8``): each generation keeps
its float parameters resident as int8 with one f32 scale per tensor
(:mod:`~dwt_tpu_torch.serve.quant`) and dequantizes them inside every
forward, through a parametrization of each parameter (``q.float() *
scale`` at each read), as the JAX engine dequantizes inside its compiled
forward.

The engine runs on CUDA unless the caller passes ``device="cpu"``; it
raises when CUDA is absent rather than choosing the CPU itself.  It
turns TF32 off for cuDNN convolutions and cuBLAS matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` set to False, process-wide):
the JAX reference's f32 eval is full f32, and parity depends on it.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from dwt_tpu_torch import obs
from dwt_tpu_torch.nn.norms import whitening_sites
from dwt_tpu_torch.serve.batcher import DEFAULT_BUCKETS, bucket_for, pad_to_bucket
from dwt_tpu_torch.serve.quant import dequantize_tensor, quantize_tensor
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.utils.checkpoint import (
    _read_manifest,
    is_jax_checkpoint,
    load_weights,
    params_digest,
    read_payload,
    restore_model,
    restore_newest,
)

log = logging.getLogger(__name__)


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` → ``cuda``.  A CUDA device without CUDA raises: the port
    serves and trains on the CPU only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on a GPU; pass "
            "device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


@dataclass(frozen=True)
class Version:
    """Identity of the weights a response was computed with: checkpoint
    step + short digest.  Stamped into every access record and
    ``/stats`` so post-swap windows are attributable to the version that
    served them.  A fresh-init engine has no checkpoint identity
    (``label`` = ``"fresh"``)."""

    step: Optional[int] = None
    digest: Optional[str] = None

    @property
    def label(self) -> str:
        if self.step is None and self.digest is None:
            return "fresh"
        d = (self.digest or "nodigest")[:8]
        return f"{self.step}-{d}"


class EngineState(NamedTuple):
    """One immutable generation of device-resident serving weights.

    ``model`` is the generation's eval-mode module; ``params`` (by
    parameter name: f32, or int8 under quantization), ``batch_stats``
    (the stat buffers by name), ``cache`` (each whitening site's eval
    matrix) and ``scales`` (the int8 dequant scale of each parameter, or
    None) are views of its tensors, so they travel as one value: a swap
    can never pair new weights with an old cache or old scales."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    cache: Dict[str, torch.Tensor]
    version: Version
    scales: Optional[Dict[str, torch.Tensor]]
    model: nn.Module


class _Dequant(nn.Module):
    """Parametrization of an int8 parameter: ``q.float() * scale`` at
    every read."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale", scale)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return dequantize_tensor(q, self.scale)


def _quantize_module(model: nn.Module) -> None:
    """Replace every float parameter of ``model`` by its int8 ``q`` under
    a :class:`_Dequant` parametrization, in place."""
    for mod in list(model.modules()):
        for leaf, p in list(mod.named_parameters(recurse=False)):
            if not p.is_floating_point():
                continue
            q, scale = quantize_tensor(p.data)
            mod._parameters[leaf] = nn.Parameter(q, requires_grad=False)
            parametrize.register_parametrization(mod, leaf, _Dequant(scale), unsafe=True)


def _resident_params(model: nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                               Optional[Dict[str, torch.Tensor]]]:
    """``({name: the tensor the device holds}, {name: scale} or None)`` of
    a generation's module, by the parameter names of the unquantized
    model: an int8 parameter's ``q`` and scale, else the parameter."""
    params: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    for prefix, mod in model.named_modules():
        if "parametrizations" in prefix.split("."):
            continue
        dot = f"{prefix}." if prefix else ""
        if parametrize.is_parametrized(mod):
            for leaf, plist in mod.parametrizations.items():
                params[dot + leaf] = plist.original
                scales[dot + leaf] = plist[0].scale
        for leaf, p in mod.named_parameters(recurse=False):
            params[dot + leaf] = p
    return params, (scales or None)


def to_channels_last(model: nn.Module) -> nn.Module:
    """Conv weights in channels_last memory format, like the activations."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d) and not parametrize.is_parametrized(mod):
            mod.weight.data = mod.weight.data.contiguous(memory_format=torch.channels_last)
    return model


class ServeEngine:
    """Bucketed eval forwards over a device-resident generation.

    ``model`` is a port model (fresh-initialized or loaded through
    :func:`dwt_tpu_torch.convert.load_jax_variables`; or use
    :meth:`from_checkpoint`); the engine takes it over as its first
    generation and keeps a CPU copy as the template later generations
    are built from.  ``input_shape`` is the per-sample shape, ``(224,
    224, 3)`` for OfficeHome.  ``step``, ``source`` and ``digest`` name
    the checkpoint the model came from (None for fresh weights).
    ``quantize`` serves int8 weights (module docstring).
    """

    input_dtype = np.dtype(np.float32)

    def __init__(
        self,
        model: nn.Module,
        input_shape: Tuple[int, ...],
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device: Optional[str] = None,
        step: Optional[int] = None,
        source: Optional[str] = None,
        digest: Optional[str] = None,
        quantize: bool = False,
    ):
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.input_shape = tuple(int(d) for d in input_shape)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.source = source
        self.quantize = bool(quantize)
        self.num_domains = getattr(model, "num_domains", 2)
        self.swap_count = 0
        self._template = copy.deepcopy(model).cpu().eval()
        install_whiten_cache(self._template, None)
        params = {n for n, _ in self._template.named_parameters()}
        self._stat_names = [k for k in self._template.state_dict() if k not in params]
        # A CPU module whose stat buffers take each adapted generation's
        # stats for the cache factorization (one build at a time).
        self._shell = copy.deepcopy(self._template)
        self._shell_lock = threading.Lock()
        self._state = self.build_state(model, version=Version(step, digest))
        self.warmup_s: Dict[int, float] = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            x = self.stage(np.zeros((b,) + self.input_shape, np.float32))
            self.forward(x, b)
            self._sync()
            self.warmup_s[b] = round(time.perf_counter() - t0, 3)
        log.info("serve engine ready on %s: buckets %s warmed in %s s (version %s)",
                 self.device, self.buckets, self.warmup_s, self.version.label)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, model: nn.Module,
                        input_shape: Tuple[int, ...], **kwargs) -> "ServeEngine":
        """Restore the newest valid checkpoint under ``ckpt_dir`` (main
        directory and anchors; the port's format or the JAX host-shard
        and delta formats) into ``model`` — parameters and stats, no
        optimizer — and build the engine from it.  A checkpoint of another
        structure or shape than ``model`` does not restore; with no
        restorable checkpoint this raises ``FileNotFoundError``, every
        candidate's reason in its message.  The version digest is the
        manifest's (what the checkpoint watcher reads), else computed
        over the restored parameters."""
        restored = restore_newest(ckpt_dir, model)
        digest = (_read_manifest(restored.path) or {}).get("params_digest")
        if digest is None:
            digest = params_digest(model.named_parameters())
        return cls(model, input_shape, step=restored.step,
                   source=restored.source, digest=digest, **kwargs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------ state / versions

    @property
    def state(self) -> EngineState:
        """The live generation — snapshot this ONCE per batch; everything
        computed from one snapshot is single-version by construction."""
        return self._state

    @property
    def version(self) -> Version:
        return self._state.version

    @property
    def step(self) -> Optional[int]:
        return self._state.version.step

    @property
    def model(self) -> nn.Module:
        """The live generation's eval module."""
        return self._state.model

    def fresh_model(self) -> nn.Module:
        """A CPU copy of the template: what a candidate restores into."""
        return copy.deepcopy(self._template)

    def _factorize_cache(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The eval matrices of ``model``'s frozen stats, factorized in
        f32 and, for a bf16 model, rounded to bf16 once (held in f32
        storage, which is what the apply kernels read)."""
        cache = make_whiten_cache(model)
        dtype = getattr(model, "dtype", None)
        if dtype not in (None, torch.float32):
            cache = {k: w.to(dtype).float() for k, w in cache.items()}
        return cache

    def _state_of(self, model: nn.Module, version: Version) -> EngineState:
        params, scales = _resident_params(model)
        stats = {k: model.get_buffer(k) for k in self._stat_names}
        cache = {k: site.eval_matrix for k, site in whitening_sites(model).items()}
        return EngineState(params, stats, cache, version, scales, model)

    @torch.no_grad()
    def build_state(self, model: nn.Module, *,
                    version: Optional[Version] = None) -> EngineState:
        """Build one swappable generation from ``model`` (which the engine
        takes over): factorize the whiten cache once from its frozen
        stats (on the model's device — the host for a checkpoint or a
        candidate — in f32), install it into the sites, quantize the
        weights when the engine serves int8, and place the module on the
        device in eval mode, conv weights in channels_last memory format
        like the activations.  Touches nothing of the live generation, so
        it is safe off the dispatcher thread."""
        with obs.span("build_state", "fleet",
                      version=version.label if version else "fresh"):
            model = model.eval()
            install_whiten_cache(model, self._factorize_cache(model))
            to_channels_last(model)
            if self.quantize:
                _quantize_module(model)
            model = model.to(self.device)
        return self._state_of(model, version or Version())

    @torch.no_grad()
    def build_state_from_stats(self, base: EngineState, batch_stats: Dict,
                               *, version: Version) -> EngineState:
        """Adapted generation: ``base``'s parameters (and int8 scales)
        unchanged and shared, ``batch_stats`` (a full stats dict, host
        arrays or tensors, each leaf in its buffer's dtype) in its own
        buffers, and the whiten cache refactorized from them on the host
        in f32 — the serving-side online-adaptation build
        (``dwt_tpu_torch.serve.adapt``).  Sharing ``base.params`` means no
        re-upload per generation and, on an int8 engine, no re-quantizing
        quantized weights.  Off-dispatcher safe like :meth:`build_state`."""
        if sorted(batch_stats) != sorted(self._stat_names):
            raise ValueError(
                f"adapted stats have keys {sorted(batch_stats)[:3]}…, not the "
                f"model's {sorted(self._stat_names)[:3]}…")
        with obs.span("build_state", "fleet", version=version.label, adapt=1):
            stats = {k: v.detach().cpu() if torch.is_tensor(v)
                     else torch.from_numpy(np.asarray(v))
                     for k, v in batch_stats.items()}
            with self._shell_lock:
                for k, v in stats.items():
                    self._shell.get_buffer(k).copy_(v)
                cache = self._factorize_cache(self._shell)
            model = copy.deepcopy(base.model, {id(p): p for p in base.model.parameters()})
            for k, v in stats.items():
                model.get_buffer(k).copy_(v)
            install_whiten_cache(model, {k: w.to(self.device) for k, w in cache.items()})
        return self._state_of(model, version)

    def build_state_from_tree(self, tree: dict, *, digest: Optional[str],
                              version: Optional[Version] = None,
                              what: str = "candidate") -> EngineState:
        """A restored checkpoint payload (``{"model": state dict, "step":
        n}`` and its parameter ``digest``, what ``utils.checkpoint.
        read_payload`` returns) → swappable generation: loaded into a
        fresh copy of the template by :func:`~dwt_tpu_torch.utils.
        checkpoint.load_weights`, where a payload of another structure or
        shape, or whose parameters do not hash to ``digest``, fails with
        ``ValueError``; then :meth:`build_state`."""
        if not isinstance(tree, dict) or "model" not in tree:
            raise ValueError(f"{what}: restored payload has no model state — "
                             "not a TrainState artifact")
        model = self.fresh_model()
        load_weights(what, model, tree["model"], digest)
        if version is None:
            step = tree.get("step")
            version = Version(None if step is None else int(step), digest)
        return self.build_state(model, version=version)

    def build_state_from_checkpoint(self, path: str, *, version: Optional[Version] = None
                                    ) -> EngineState:
        """One finalized checkpoint directory → swappable generation: a
        port checkpoint (full or delta) through :meth:`build_state_from_tree`
        with its manifest's digest, a JAX package's through
        :func:`~dwt_tpu_torch.utils.checkpoint.restore_model` into a fresh
        copy of the template.  Raises ``ValueError``/``OSError`` for a
        candidate that does not restore.  The read is the ``reload_restore``
        span (the JAX reloader's), the build the ``build_state`` span after
        it."""
        restore = obs.span("reload_restore", "fleet",
                           step=None if version is None else version.step)
        if not is_jax_checkpoint(path):
            with restore:
                payload, digest = read_payload(path)
            return self.build_state_from_tree(payload, digest=digest, version=version,
                                              what=path)
        model = self.fresh_model()
        with restore:
            step = restore_model(path, model)
        if version is None:
            digest = (_read_manifest(path) or {}).get("params_digest")
            version = Version(step, digest or params_digest(model.named_parameters()))
        return self.build_state(model, version=version)

    def swap(self, state: EngineState) -> EngineState:
        """Atomic generation flip; returns the PREVIOUS state (the deploy
        controller keeps it as the rollback buffer).  The single
        reference assignment is the whole cutover: batches whose snapshot
        predates it finish on the old generation, the next snapshot
        serves the new one."""
        prev = self._state
        self._state = state
        self.swap_count += 1
        log.info("serve engine swapped: %s -> %s (swap #%d)",
                 prev.version.label, state.version.label, self.swap_count)
        return prev

    # ------------------------------------------------------------ inference

    def stage(self, x: np.ndarray) -> torch.Tensor:
        """H2D placement of one bucket batch (pinned host memory,
        non-blocking copy on the current stream)."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def forward(self, x_staged: torch.Tensor, bucket: int,
                state: Optional[EngineState] = None) -> torch.Tensor:
        """Eval forward of one staged bucket batch → device logits (f32).
        ``state`` pins the generation (the dispatcher passes its per-batch
        snapshot, the canary a candidate under test); default is the live
        one."""
        if int(bucket) not in self.buckets:
            raise ValueError(
                f"no warmed forward for bucket {bucket} (buckets: {self.buckets})"
            )
        if tuple(x_staged.shape) != (int(bucket),) + self.input_shape:
            raise ValueError(
                f"staged batch {tuple(x_staged.shape)} is not "
                f"[{bucket}, {', '.join(map(str, self.input_shape))}]"
            )
        st = self._state if state is None else state
        return st.model(x_staged).float()

    def infer(self, x: np.ndarray, bucket: Optional[int] = None,
              state: Optional[EngineState] = None) -> np.ndarray:
        """Synchronous pad → stage → forward → fetch; returns the
        ``[n, classes]`` logits of the real rows only.  ``state`` as in
        :meth:`forward` (the canary's fixture eval of a candidate)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if bucket is None:
            bucket = bucket_for(n, self.buckets)
        elif n < 1 or n > bucket:
            raise ValueError(f"got {n} samples for bucket {bucket}")
        logits = self.forward(self.stage(pad_to_bucket(x, bucket)), bucket, state=state)
        return logits.cpu().numpy()[:n]
