"""dwt_tpu_torch — the PyTorch/CUDA port of ``dwt_tpu`` for NVIDIA Hopper.

The port grows slice by slice beside the JAX package, which stays the
reference.  Module names mirror ``dwt_tpu``'s so each counterpart is easy
to find.  This package imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``dwt_tpu``.

Slice 1 is the serving path: the eval-mode ResNet-DWT forward behind
the micro-batching HTTP server, with every whitened site going through
the hand-written CUDA whitening-apply kernel
(``dwt_tpu_torch/csrc/whiten_apply.cu``).  Slice 2 is OfficeHome
training (``python -m dwt_tpu_torch.cli.officehome``): the MEC train
step, stat collection and eval, every whitened site in train mode going
through the hand-written moments kernel
(``dwt_tpu_torch/csrc/whiten_moments.cu``) and the apply kernel.
Slice 4 is the digits experiment: LeNet-DWT trained on USPS→MNIST with
Adam and the entropy loss (``python -m dwt_tpu_torch.cli.usps_mnist``)
and served by the same server (``--model lenet``), through both kernels.
Slices 6–8 add the data plane, checkpoints and exact resume, and the
resilience plane (``dwt_tpu_torch.resilience``, ``dwt_tpu_torch.ckpt``):
background and delta checkpoints, the divergence guard, preemption, the
watchdog and the fault plans.
"""

__version__ = "0.1.0"
