"""Model of the port: the dense GQA decoder, trained full-sequence and
served from the paged cache."""
from .model import Model, params_from_jax

__all__ = ["Model", "params_from_jax"]
