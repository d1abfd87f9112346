# Method-of-lines time steppers over the alpha*M + beta*F operator
# interface. Port of flow_tpu/parabolic.py. A spatial operator provides
#   eval_alpha_M_beta_F(alpha, beta, u, t)   ->  alpha*M*u + beta*F(u, t)
#   solve_alpha_M_beta_F(alpha, beta, b, t)  ->  u with alpha*M*u + beta*F = b
# (heat.Heat does).
from __future__ import annotations

__all__ = ["ExplicitEuler", "ImplicitEuler", "Trapezoidal"]


class ImplicitEuler:
    """M (u1 - u0)/dt = F(t+dt, u1)."""

    def __init__(self, problem):
        self.problem = problem

    def step(self, u0, t, dt):
        b = self.problem.eval_alpha_M_beta_F(1.0 / dt, 0.0, u0, t)
        return self.problem.solve_alpha_M_beta_F(1.0 / dt, -1.0, b, t + dt)


class ExplicitEuler:
    """M (u1 - u0)/dt = F(t, u0)."""

    def __init__(self, problem):
        self.problem = problem

    def step(self, u0, t, dt):
        b = self.problem.eval_alpha_M_beta_F(1.0 / dt, 1.0, u0, t)
        return self.problem.solve_alpha_M_beta_F(1.0 / dt, 0.0, b, t + dt)


class Trapezoidal:
    """M (u1 - u0)/dt = 0.5*(F(t, u0) + F(t+dt, u1))."""

    def __init__(self, problem):
        self.problem = problem

    def step(self, u0, t, dt):
        b = self.problem.eval_alpha_M_beta_F(1.0 / dt, 0.5, u0, t)
        return self.problem.solve_alpha_M_beta_F(1.0 / dt, -0.5, b, t + dt)
