from admmnet_tpu_torch.solver.admm import ADMMResult, admm_solve, admm_solve_fixed

__all__ = ["ADMMResult", "admm_solve", "admm_solve_fixed"]
