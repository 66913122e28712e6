"""The LM substrate: blocks, the ``LM`` assembly and its factory."""

from .lm import LM
from .registry import build_model, concrete_inputs

__all__ = ["LM", "build_model", "concrete_inputs"]
