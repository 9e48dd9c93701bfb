"""Bucketed inference engine: the deployment forward, warmed once per bucket.

The port of ``dwt_tpu.serve.engine.ServeEngine``.  The deployment
artifact is the target-branch eval forward — frozen running stats,
domain-specific whitening at test time:

* **whiten once**: every site's eval whitening matrix is factorized from
  the frozen stats in one batched call (:func:`dwt_tpu_torch.train.
  evalpipe.make_whiten_cache`, which the eval pipeline uses too) and
  installed into the sites (the counterpart of
  ``dwt_tpu.train.steps.eval_variables``, which threads the cache
  collection into ``model.apply``);
* **device-resident**: the model, its stats and the cache are placed on
  the device once; per request only the bucket batch moves (H2D from
  pinned memory) and the logits come back;
* **warm once per bucket**: one forward per bucket shape at construction
  (the counterpart of the JAX engine's AOT compile), so the first
  request of any size pays no first-call set-up;
* the forward itself is ``model(x)`` in eval mode under
  ``torch.inference_mode`` — ``dwt_tpu.train.steps.make_serve_forward``;
* **from a checkpoint**: :meth:`ServeEngine.from_checkpoint` restores the
  parameters and stats of the newest valid step (main directory and
  anchors) without an optimizer — a checkpoint the port trained, or one
  the JAX package wrote in its host-shard format — and records its
  ``step`` and ``source``.

The engine runs on CUDA unless the caller passes ``device="cpu"``; it
raises when CUDA is absent rather than choosing the CPU itself.  It
turns TF32 off for cuDNN convolutions and cuBLAS matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` set to False, process-wide):
the JAX reference's f32 eval is full f32, and parity depends on it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch.serve.batcher import DEFAULT_BUCKETS, bucket_for, pad_to_bucket
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.utils.checkpoint import restore_newest

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


class ServeEngine:
    """Bucketed eval forwards over a device-resident model.

    ``model`` is a port model (fresh-initialized or loaded through
    :func:`dwt_tpu_torch.convert.load_jax_variables`; or use
    :meth:`from_checkpoint`); ``input_shape`` is the per-sample shape,
    ``(224, 224, 3)`` for OfficeHome.  ``step`` and ``source`` name the
    checkpoint the model came from (None for fresh weights).
    """

    def __init__(
        self,
        model: nn.Module,
        input_shape: Tuple[int, ...],
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device: Optional[str] = None,
        step: Optional[int] = None,
        source: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.input_shape = tuple(int(d) for d in input_shape)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.step = step
        self.source = source
        self.model = self.build_state(model)
        self.warmup_s: Dict[int, float] = {}
        for b in self.buckets:
            t0 = time.perf_counter()
            x = self.stage(np.zeros((b,) + self.input_shape, np.float32))
            self.forward(x, b)
            self._sync()
            self.warmup_s[b] = round(time.perf_counter() - t0, 3)
        log.info("serve engine ready on %s: buckets %s warmed in %s s",
                 self.device, self.buckets, self.warmup_s)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, model: nn.Module,
                        input_shape: Tuple[int, ...], **kwargs) -> "ServeEngine":
        """Restore the newest valid checkpoint under ``ckpt_dir`` (main
        directory and anchors; the port's format or the JAX host-shard
        format) into ``model`` — parameters and stats, no optimizer — and
        build the engine from it.  A checkpoint of another structure or
        shape than ``model`` does not restore; with no restorable
        checkpoint this raises ``FileNotFoundError``, every candidate's
        reason in its message."""
        restored = restore_newest(ckpt_dir, model)
        return cls(model, input_shape, step=restored.step,
                   source=restored.source, **kwargs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def build_state(self, model: nn.Module) -> nn.Module:
        """Factorize the whiten cache once from the frozen stats (on the
        host, in f32), install it into the sites, then place the model on
        the device in eval mode, conv weights in channels_last memory
        format like the activations."""
        model = model.eval()
        install_whiten_cache(model, make_whiten_cache(model))
        model = model.to(self.device)
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                mod.weight.data = mod.weight.data.contiguous(
                    memory_format=torch.channels_last
                )
        return model

    def stage(self, x: np.ndarray) -> torch.Tensor:
        """H2D placement of one bucket batch (pinned host memory,
        non-blocking copy on the current stream)."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def forward(self, x_staged: torch.Tensor, bucket: int) -> torch.Tensor:
        """Eval forward of one staged bucket batch → device logits."""
        if int(bucket) not in self.buckets:
            raise ValueError(
                f"no warmed forward for bucket {bucket} (buckets: {self.buckets})"
            )
        if tuple(x_staged.shape) != (int(bucket),) + self.input_shape:
            raise ValueError(
                f"staged batch {tuple(x_staged.shape)} is not "
                f"[{bucket}, {', '.join(map(str, self.input_shape))}]"
            )
        return self.model(x_staged)

    def infer(self, x: np.ndarray, bucket: Optional[int] = None) -> np.ndarray:
        """Synchronous pad → stage → forward → fetch; returns the
        ``[n, classes]`` logits of the real rows only."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if bucket is None:
            bucket = bucket_for(n, self.buckets)
        elif n < 1 or n > bucket:
            raise ValueError(f"got {n} samples for bucket {bucket}")
        logits = self.forward(self.stage(pad_to_bucket(x, bucket)), bucket)
        return logits.cpu().numpy()[:n]
