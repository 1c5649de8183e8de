"""Helpers without a device path, copied from the JAX package's JAX-free
``utils/`` modules."""
