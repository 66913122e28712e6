"""Batched device SPECTRA pipeline in PyTorch: matchers, DECOMPOSE + LPT,
EQUALIZE, §IV bounds and the fused end-to-end call."""

from .e2e import E2EResult, spectra_torch_e2e_many

__all__ = ["E2EResult", "spectra_torch_e2e_many"]
