"""Examples of the port that drive its device path, each the twin of an
example under ``examples/``: ``python -m repro_torch.examples.<name>
[--device cpu]``."""
