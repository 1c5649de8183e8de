"""The port's op-graph physics against the JAX package's, function by
function, on Go1 on the ``jump`` scene (states on, over the edge of and
sunk into its box: the sphere-vs-box branch of the contact), on Go1 with
the oracle foot contact (``assets.go1_oracle_contact``: progressive
impedance, torsional and rolling friction) and on mini (one-dof legs: the
n = 1 leg inverse).  Cases and tolerances: ``tests/test_torch_dynamics.py``.
"""
import pytest
import torch

from test_torch_dynamics import check_function, function_cases

torch.set_num_threads(1)


@pytest.mark.parametrize("function,model",
                         function_cases(("go1_jump", "go1_oracle", "mini")))
def test_function_matches_jax(function, model):
    """``function`` of the port against the JAX package's on the case's
    batch of 8: 1e-5 relative and 1e-5 absolute (D: of its largest entry),
    booleans equal."""
    check_function(function, model)
