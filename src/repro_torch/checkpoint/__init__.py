"""Checkpointing of the train state."""
from . import store

__all__ = ["store"]
