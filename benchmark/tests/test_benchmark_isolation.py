"""Nothing the benchmark runs loads JAX, its libraries or the JAX package
(``opendog_tpu``), and the reference loads nothing of the program
(``opendog_tpu_torch``).  Top-level module names are compared whole:
``opendog_tpu_torch`` starts with ``opendog_tpu`` and is not it.  Each
check runs in a fresh interpreter, so that what the test process itself
loaded does not count."""
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

FORBIDDEN = ["jax", "jaxlib", "flax", "opendog_tpu"]


def loaded_after(code: str):
    """The top-level names of the modules loaded after running ``code``
    in a fresh interpreter at the repository root."""
    probe = (code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')"
             "[0] for m in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def _modules(sub: str):
    base = os.path.join(spec.BENCH, sub)
    out = []
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py") and f != "__init__.py":
                rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
                out.append(rel[:-3].replace(os.sep, "."))
    return out


def test_harness_readers_drivers_and_reference_load_no_jax():
    mods = (["benchmark.harness.cli", "benchmark.harness.ranks",
             "benchmark.harness.window", "benchmark.harness.trace"]
            + _modules("metrics") + _modules("drivers")
            + _modules("reference"))
    names = loaded_after("\n".join(f"import {m}" for m in mods))
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_program_the_drivers_set_up_loads_no_jax():
    code = ("import benchmark.drivers.mpc_closed_loop\n"
            "from opendog_tpu_torch import assets, parallel, physics, "
            "solvers\nfrom opendog_tpu_torch.ops import cuda_step")
    names = loaded_after(code)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "opendog_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("\n".join(f"import {m}"
                                   for m in _modules("reference")))
    assert "opendog_tpu_torch" not in names
    assert not names & set(FORBIDDEN)


@pytest.mark.parametrize("name,found", [
    ("opendog_tpu_torch.solvers", []), ("opendog_tpu.solvers", ["opendog_tpu"]),
    ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("jaxtyping", [])])
def test_the_run_s_own_look_compares_whole_names(name, found, monkeypatch):
    from benchmark.harness import cli
    keep = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(keep, **{name: object()}))
    assert cli.forbidden_modules() == found


def test_a_rank_that_loads_jax_gives_no_result():
    """The four-chip cell's windows run in rank processes, which look at
    their own modules: one that finds ``jax`` ends the run with no result."""
    import time
    from benchmark.harness import cli
    from benchmark.tests.test_benchmark_faults import SMALL
    with pytest.raises(RuntimeError, match=r"(?s)exited 4.*\['jax'\]"):
        cli.run_cell(spec.Cell("go1_trot_k4096_x4"), 2 ** 31 + 7, 1.0, False,
                     time.time(), device="cpu", overrides=SMALL,
                     rank_module="benchmark.tests._rank_loading_jax")
