"""Learning on top of the MPC stack: the policy network, the reader of the
JAX package's saved students, and MPC-to-policy distillation."""
