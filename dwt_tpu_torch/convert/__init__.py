"""Weight bridges into the port."""

from dwt_tpu_torch.convert.from_jax import load_jax_variables

__all__ = ["load_jax_variables"]
