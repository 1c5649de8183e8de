"""Helpers: copies of the JAX package's JAX-free ``utils/`` modules, the
port's rendering and checkpoints, and the counterparts of its profiling
(:mod:`.profiling`, on ``torch.profiler`` and aten op counts) and of its
compilation cache (:mod:`.compile_cache`, the source-hashed kernel
build)."""
