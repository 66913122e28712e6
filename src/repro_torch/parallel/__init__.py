"""Sharding rules (DTensor placements) and the single-device and sharded step builders."""
