"""opendog_tpu_torch — the PyTorch / CUDA port of ``opendog_tpu``.

A second package beside the JAX one, which stays the reference.  It
carries the Go1 flat-ground MPPI trot loop, OpenDOG terrain MPC and
payload-aware MPPI: the MJCF models, the op-graph Featherstone step and
terrain (:mod:`.physics`, :mod:`.assets`), the fused physics substep as
CUDA kernels in each of its modes with their plain PyTorch version
(:mod:`.ops`, ``csrc/``) and the MPPI / MPC solvers with their costs,
on the kernel or on the op-graph step (:mod:`.solvers`), and policy
learning: distillation and PPO on the task envs (:mod:`.rl`,
:mod:`.envs`, :mod:`.train`, :mod:`.eval`).  Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
