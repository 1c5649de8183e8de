"""Learning: the policy network, the reader of the JAX package's saved
students, MPC-to-policy distillation, and PPO with its adaptive schedule
and deterministic eval."""
