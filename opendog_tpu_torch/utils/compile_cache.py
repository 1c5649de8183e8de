"""The port's compilation cache: the source-hashed build of ``csrc/``.

The JAX package points JAX at a persistent XLA compilation cache
(``utils/compile_cache.py``) so that a process after the first skips the
compile.  The port compiles no XLA program.  What it compiles is its CUDA
C++ (and the g++ builds of ``csrc/`` and ``native/``), and those are
already cached on disk: ``ops/build.py`` keys each library by a hash of its
compiler command and of every source, builds it once under a file lock
into ``BUILD_DIR`` (``opendog_tpu_torch/_build/``, kept out of git), and
every later process loads it.  :func:`enable` names that directory; it
adds no second cache.
"""
import os

from ..ops.build import BUILD_DIR


def enable() -> str:
    """The directory of the port's compiled libraries (made if missing):
    the counterpart of the JAX package's cache directory.  Safe to call
    more than once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR
