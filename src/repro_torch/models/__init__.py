"""Model of the port: the dense GQA decoder on the paged serving path."""
from .model import Model, params_from_jax

__all__ = ["Model", "params_from_jax"]
