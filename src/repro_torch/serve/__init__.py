"""Serving: batched LM decode (``DecodeEngine``)."""

from .engine import DecodeEngine, GenerationResult

__all__ = ["DecodeEngine", "GenerationResult"]
