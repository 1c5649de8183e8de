"""Reward and cost primitives of the task environments."""
