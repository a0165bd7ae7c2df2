"""LearningAgileFlight-SE3 in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch port of `learningagileflight_se3_tpu` (the JAX reference, which
stays beside it unchanged).  It imports `torch` and numpy, never `jax`.

It holds the batched control-limited DDP solver, the 10 Hz deployment tick
above it, and stage-2 training: differentiable-MPC RL of DNN1 with the
analytic (implicit-function VJP) and finite-difference learning signals.

Layering (bottom -> top):
  config.py  frozen dataclasses mirroring the JAX package's configs
  core/      quaternion / rotation math
  dynamics/  13-state quadrotor ODE and the forward-Euler step
  costs/     goal / traversal / thrust stage costs, the shooting cost
  solver/    chol4, boxQP, closed-form derivatives, the batched DDP solver,
             the parallel-in-time Riccati sweep (parallel_riccati.py), the
             differentiable solve (diff.py)
  ops/       the three CUDA kernels (csrc/) with their plain PyTorch versions
  geometry/  gate kinematics, the 18-dim DNN2 window input, the collision
             score and trajectory reward
  models/    DNN1/DNN2 MLPs and the scenario sampler
  policy.py  the RL learning signals through the batched solve
  train/     the three training stages (pretrain.py, rl.py, imitation.py)
  parallel/  multi-process data parallelism: the scenario mesh, the process
             group, the sharded dry run
  sim/       traversal-time fixed point, the external-simulator tick, the
             closed loop, the validation flight and the PyBullet harness
  oracle/    the independent yardsticks, on the host in float64: the numpy
             plant and cost, the shooting and lifted-NLP oracles
  native.py  bindings of the C++ plant, sampler and reward (native/fastquad.cpp)
  benchmarks/  the counterparts of bench.py and benchmarks/*.py: the batched
             solve's throughput and quality, the kernel path against the
             plain path, the query latency, the real-time tick with its
             success rate, the accuracy against the oracle, the scaling rows
  utils/     flax -> torch weight conversion, training-state checkpoints,
             the URDF / OBJ asset generators

A tensor on the CPU runs through the plain PyTorch versions; a tensor on a
CUDA device runs through the kernels (built with nvcc at first use).
"""

__version__ = "0.1.0"
