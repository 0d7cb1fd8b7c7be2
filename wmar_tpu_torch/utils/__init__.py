"""Utilities: evaluation metrics, training monitors, parameter-tree files
(flax msgpack) and RCC deltas."""
