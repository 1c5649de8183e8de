"""A rank that loads a module named ``jax`` (an empty stand-in) once its
window has closed: the four-chip cell must then print no result.  Run by
``ranks.spawn`` in place of ``benchmark.harness.ranks``."""
import json
import sys
import types

from benchmark.harness import ranks, window

_run_rank = window.run_rank


def _run_then_load_jax(*args, **kwargs):
    out = _run_rank(*args, **kwargs)
    sys.modules["jax"] = types.ModuleType("jax")
    return out


window.run_rank = _run_then_load_jax

if __name__ == "__main__":
    sys.exit(ranks.main(json.loads(sys.argv[1])))
