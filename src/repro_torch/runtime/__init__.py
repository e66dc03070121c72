"""Runtime: the train state and step, fault tolerance, the training loop."""
from . import steps

__all__ = ["steps"]
