"""Roofline analysis of a traced sharded step (``repro.analysis``)."""
