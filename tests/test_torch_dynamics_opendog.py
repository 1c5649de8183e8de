"""The port's op-graph physics against the JAX package's, function by
function, on OpenDOG on flat ground and on a generated terrain (bilinear
heightfield contact, the JAX package's heights carried across).  Cases and
tolerances: ``tests/test_torch_dynamics.py``.
"""
import pytest
import torch

from test_torch_dynamics import check_function, function_cases

torch.set_num_threads(1)


@pytest.mark.parametrize("function,model",
                         function_cases(("opendog", "opendog_terrain")))
def test_function_matches_jax(function, model):
    """``function`` of the port against the JAX package's on the case's
    batch of 8: 1e-5 relative and 1e-5 absolute (D: of its largest entry),
    booleans equal."""
    check_function(function, model)
