"""LearningAgileFlight-SE3 in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch port of `learningagileflight_se3_tpu` (the JAX reference, which
stays beside it unchanged).  It imports `torch` and numpy, never `jax`.

This slice holds the serving path: the batched control-limited DDP solver
and the 10 Hz deployment tick above it.

Layering (bottom -> top):
  config.py  frozen dataclasses mirroring the JAX package's configs
  core/      quaternion / rotation math
  dynamics/  13-state quadrotor ODE and the forward-Euler step
  costs/     goal / traversal / thrust stage costs
  solver/    chol4, boxQP, closed-form derivatives, the batched DDP solver
  ops/       the two CUDA kernels (csrc/) with their plain PyTorch versions
  geometry/  gate kinematics and the 18-dim DNN2 window input
  models/    DNN1/DNN2 MLPs and the scenario sampler
  sim/       traversal-time fixed point and the external-simulator tick
  utils/     flax -> torch weight conversion

A tensor on the CPU runs through the plain PyTorch versions; a tensor on a
CUDA device runs through the kernels (built with nvcc at first use).
"""

__version__ = "0.1.0"
