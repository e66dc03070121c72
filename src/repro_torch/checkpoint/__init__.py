"""Checkpointing of the train state and of the serving snapshots."""
from . import store

__all__ = ["store"]
