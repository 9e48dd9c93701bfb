"""Weight bridges into the port: the JAX package's variables and the reference's PyTorch checkpoint."""

from dwt_tpu_torch.convert.from_jax import load_jax_variables
from dwt_tpu_torch.convert.torch_resnet import (
    ConversionReport,
    convert_resnet_state_dict,
    load_pytorch_checkpoint,
)

__all__ = [
    "ConversionReport",
    "convert_resnet_state_dict",
    "load_jax_variables",
    "load_pytorch_checkpoint",
]
