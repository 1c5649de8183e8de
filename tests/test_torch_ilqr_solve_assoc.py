"""One whole ``make_ilqr`` solve with the associative Riccati pass against
the JAX package's, on the inputs and at the tolerances of
test_torch_ilqr_solve.py (a file of its own: each JAX solve takes about a
minute to compile on a CPU)."""
import torch

from test_torch_ilqr_solve import compare_solve

torch.set_num_threads(1)


def test_associative_solve_matches_jax():
    compare_solve("associative")
