"""opendog_tpu_torch — the PyTorch / CUDA port of ``opendog_tpu``.

A second package beside the JAX one, which stays the reference.  This
slice carries the Go1 flat-ground MPPI trot loop: the MJCF models
(:mod:`.physics`, :mod:`.assets`), the fused physics substep as a CUDA
kernel with its plain PyTorch version (:mod:`.ops`, ``csrc/``) and the
MPPI / MPC solvers with their costs (:mod:`.solvers`).  Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
