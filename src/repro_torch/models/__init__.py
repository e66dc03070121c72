"""Model of the port: decoder stacks with GQA or MLA attention and dense or
MoE FFNs, or Mamba2's SSD mixer, trained full-sequence (attention stacks)
and served from the paged or the dense cache."""
from .model import Model, params_from_jax

__all__ = ["Model", "params_from_jax"]
