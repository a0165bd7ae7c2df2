"""Independent yardsticks of the solver, computed on the host in float64:
the numpy plant and cost, the L-BFGS-B shooting oracle and the lifted-NLP
oracle.  Test-only: nothing on the solver's path imports them."""

from learningagileflight_se3_torch.oracle.numpy_reference import (
    np_quad_ode,
    np_euler_step,
    np_rollout,
    np_total_cost,
)
from learningagileflight_se3_torch.oracle.shooting import solve_shooting_oracle
from learningagileflight_se3_torch.oracle.lifted_nlp import (
    LiftedSolution,
    solve_lifted_oracle,
)
