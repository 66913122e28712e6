"""Step builders (single device; the sharded steps are not ported yet)."""
