"""ViT-DWT — ``dwt_tpu.nn.vit`` in PyTorch, train and eval.

Domain whitening at transformer module boundaries: the per-domain grouped
whitening of the conv nets applied to the token stream ``[B, L, C]`` at
the patch-embed boundary (``dn_patch``) and at the boundary of each of the
first ``max(1, depth // 4)`` blocks (``blk{i}.dn``); the deeper blocks end
in domain BN.  A norm site reduces over all leading axes, so in train mode
the merged ``[D·N, L, C]`` tokens reach it as each domain's ``[N·L, C]``
rows (``nn.norms.apply_domain_norm``, a view: no copy), and in eval mode
as ``[N·L, C]`` — the same ``[M, C]`` operands the CUDA kernels take at
the conv nets' sites, at the token width.

Same submodule names as the Flax model (``conv_patch``, ``pos_embed``,
``dn_patch``, ``blk{i}`` with ``ln1``, ``attn_q/k/v/out``, ``ln2``,
``mlp_fc1/fc2`` and ``dn``, then ``ln_out`` and ``fc_out``), so the weight
bridge maps scope paths one to one and the two-group SGD finds the same
``fc_out`` head.  What the Flax model does, the port does:

* LayerNorm with Flax's epsilon 1e-6 (torch's default is 1e-5), its
  statistics in f32 under a bf16 input, its output in the input's dtype
  (:class:`LayerNorm`);
* GELU in its tanh approximation (``flax.linen.gelu``);
* attention written out: ``q``, ``k``, ``v`` as plain dense layers, heads
  split as ``[B, H, L, hd]``, ``softmax(q·kᵀ · hd^-½)·v`` (a bf16
  softmax is computed in f32 inside ``torch.softmax`` and rounded once;
  ``jax.nn.softmax`` exponentiates and divides in bf16 — equal within
  bf16's tolerance);
* ``pos_embed [1, L, C]``: L is fixed by the image size given at
  construction (224 at patch 16: 196); an input of another size, or one
  the patch does not divide, raises;
* tokens in row-major (h, w) order: the patch conv's output in
  ``channels_last`` memory, permuted to ``[B, H', W', C]``, is a
  contiguous view, so ``reshape(B, L, C)`` is JAX's reshape, without a
  copy;
* the head: mean over tokens, ``fc_out`` padded by ``pad_classes_to``,
  sliced to ``num_classes``.

``dtype`` is the compute dtype as in ``nn.resnet`` (:func:`cast_forward`
for the patch conv and every dense layer; ``None`` computes in the
parameters' own dtype); ``remat`` recomputes each block in the backward
(``nn.norms.remat``).  Input contract: ``[D, N, H, W, 3]`` in train mode →
logits ``[D, N, K]``; ``[N, H, W, 3]`` in eval mode → ``[N, K]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dwt_tpu_torch.nn.norms import (
    DomainBatchNorm,
    DomainWhiten,
    merge_domains,
    remat,
    split_domains,
)
from dwt_tpu_torch.nn.resnet import cast_forward, init_modules_, padded_num_classes

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


class LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm`` over the last axis: epsilon 1e-6, the
    statistics and the affine in at least f32 (a bf16 input is upcast),
    the result in the input's dtype."""

    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(dtype), self.normalized_shape,
                         self.weight.to(dtype), self.bias.to(dtype), self.eps)
        return y.to(x.dtype)


def _domain_norm(features: int, use_whitening: bool, group_size: int,
                 num_domains: int, eval_domain: int, momentum: float,
                 whitener: str) -> nn.Module:
    if use_whitening:
        return DomainWhiten(features, group_size, num_domains, eval_domain,
                            momentum, whitener=whitener)
    return DomainBatchNorm(features, num_domains, eval_domain, momentum)


class TransformerBlockDWT(nn.Module):
    """Pre-LN transformer block ending in a domain norm site (``dn``):
    whitening when ``use_whitening``, else domain BN.  Input and output
    ``[B, L, C]``, contiguous (in train mode ``B = D·N``)."""

    def __init__(
        self,
        width: int,
        num_heads: int,
        mlp_ratio: int = 4,
        use_whitening: bool = False,
        group_size: int = 4,
        num_domains: int = 3,
        eval_domain: int = 1,
        momentum: float = 0.1,
        dtype: Optional[torch.dtype] = None,
        whitener: str = "cholesky",
    ):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} does not split into {num_heads} heads")
        self.width, self.num_heads = width, num_heads
        self.head_dim = width // num_heads
        self.dtype = dtype
        self.ln1 = LayerNorm(width)
        self.attn_q = nn.Linear(width, width)
        self.attn_k = nn.Linear(width, width)
        self.attn_v = nn.Linear(width, width)
        self.attn_out = nn.Linear(width, width)
        self.ln2 = LayerNorm(width)
        self.mlp_fc1 = nn.Linear(width, width * mlp_ratio)
        self.mlp_fc2 = nn.Linear(width * mlp_ratio, width)
        self.dn = _domain_norm(width, use_whitening, group_size, num_domains,
                               eval_domain, momentum, whitener)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """``[B, L, C]`` → ``[B, H, L, hd]``."""
        return t.unflatten(-1, (self.num_heads, self.head_dim)).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.ln1(x)
        q, k, v = (self._heads(cast_forward(m, h, dt))
                   for m in (self.attn_q, self.attn_k, self.attn_v))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.head_dim ** -0.5, dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(x.shape[:-1] + (self.width,))
        x = x + cast_forward(self.attn_out, o, dt)
        h = F.gelu(cast_forward(self.mlp_fc1, self.ln2(x), dt), approximate="tanh")
        x = x + cast_forward(self.mlp_fc2, h, dt)
        return self.dn(x)


class ViTDWT(nn.Module):
    """ViT backbone with domain whitening at module boundaries; the module
    docstring has the contract.  ``image_size`` fixes ``pos_embed``'s
    length."""

    def __init__(
        self,
        patch_size: int = 16,
        depth: int = 12,
        width: int = 384,
        num_heads: int = 6,
        mlp_ratio: int = 4,
        num_classes: int = 65,
        group_size: int = 4,
        num_domains: int = 3,
        eval_domain: int = 1,
        momentum: float = 0.1,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        whitener: str = "cholesky",
        pad_classes_to: int = 0,
        image_size: int = 224,
    ):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not divisible by "
                             f"patch_size={patch_size}")
        self.patch_size, self.width, self.depth = patch_size, width, depth
        self.image_size = image_size
        self.num_classes = num_classes
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.dtype = dtype
        self.remat = remat
        self.conv_patch = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        tokens = (image_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, width))
        self.dn_patch = DomainWhiten(width, group_size, num_domains, eval_domain,
                                     momentum, whitener=whitener)
        # The first quarter of the blocks whiten (at least one), the rest
        # BN: the ResNet's stem + stage-1 recipe transplanted to depth.
        whiten_depth = max(1, depth // 4)
        for i in range(depth):
            self.add_module(f"blk{i}", TransformerBlockDWT(
                width, num_heads, mlp_ratio,
                use_whitening=i < whiten_depth,
                group_size=group_size, num_domains=num_domains,
                eval_domain=eval_domain, momentum=momentum, dtype=dtype,
                whitener=whitener))
        self.ln_out = LayerNorm(width)
        self.fc_out = nn.Linear(width, padded_num_classes(num_classes, pad_classes_to))

    @classmethod
    def vit_dwt(cls, **kw) -> "ViTDWT":
        """ViT-S/16: patch 16, 12 deep, 384 wide, 6 heads, MLP ratio 4."""
        return cls(**kw)

    @classmethod
    def vit_tiny(cls, **kw) -> "ViTDWT":
        """The small twin for tests: patch 4, 2 deep, 32 wide, 4 heads."""
        return cls(patch_size=4, depth=2, width=32, num_heads=4, **kw)

    def blocks(self):
        for i in range(self.depth):
            yield getattr(self, f"blk{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if x.dim() != 5 or x.shape[0] != self.num_domains:
                raise ValueError(
                    f"train input must be [domains={self.num_domains}, N, H, "
                    f"W, C]; got {tuple(x.shape)}"
                )
            x = merge_domains(x)
        h, w = x.shape[-3:-1]
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input spatial dims {(h, w)} must be divisible "
                             f"by patch_size={p}")
        if (h // p) * (w // p) != self.pos_embed.shape[1]:
            raise ValueError(
                f"input spatial dims {(h, w)} give {(h // p) * (w // p)} tokens; "
                f"pos_embed holds {self.pos_embed.shape[1]} (image_size="
                f"{self.image_size})")
        if self.dtype is not None:
            x = x.to(self.dtype)
        # NHWC in; the permuted view is channels_last memory, and so is the
        # patch conv's output: back to [B, H', W', C] it is contiguous, and
        # its row-major (h, w) tokens are JAX's.
        x = cast_forward(self.conv_patch, x.permute(0, 3, 1, 2), self.dtype)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.width)
        x = self.dn_patch(x + self.pos_embed.to(x.dtype))
        checkpointed = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks():
            x = remat(block, x) if checkpointed else block(x)
        x = self.ln_out(x).mean(dim=-2)  # mean pool over tokens → [B, C]
        x = cast_forward(self.fc_out, x, self.dtype)
        x = x[:, : self.num_classes]  # no-op unless the head is padded
        if self.training:
            x = split_domains(x, self.num_domains)
        return x


@torch.no_grad()
def init_vit_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh weights from ``seed`` with the Flax model's initializers: the
    patch conv and the dense layers as ``nn.resnet.init_modules_`` draws
    them, LayerNorms γ=1 and β=0, ``pos_embed`` from N(0, 0.02²); the norm
    sites keep the affines and fresh stats they are built with."""
    gen = torch.Generator().manual_seed(seed)
    init_modules_(model, gen)
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    nn.init.normal_(model.pos_embed, 0.0, 0.02, generator=gen)
    return model
