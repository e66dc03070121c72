"""Data pipeline of the port's training path."""
from .pipeline import DataConfig, Dataset

__all__ = ["DataConfig", "Dataset"]
