"""Optimizer of the port's training path (AdamW with f32 master weights)."""
from . import adamw

__all__ = ["adamw"]
