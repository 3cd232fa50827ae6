"""Basic 2D p-Laplace solve — the reference quickstart
(reference README.md:28-48) in this framework.

Run:  python examples/basic_solve.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import multigridbarrier_tpu as mgb

# Solve the p=1 p-Laplace problem on [-1,1]^2 (reference:
# fem2d_mpi_solve(Float64; L=3, p=1.0))
sol = mgb.fem2d_solve(L=3, p=1.0, verbose=True)

print("solution shape:", sol.z.shape)
print("Newton iterations per level:", sol.SOL_main.its.tolist())
print("barrier path:", [f"{t:.1e}" for t in sol.SOL_main.ts])
print("c_dot_Dz trace:", [f"{v:.6e}" for v in sol.SOL_main.c_dot_Dz])
print("solve wall time:", f"{sol.SOL_main.t_elapsed:.2f}s")

# gather to host numpy (the reference's mpi_to_native)
native = mgb.device_to_native(sol)

# visualize + persist
mgb.plot(sol, fname="solution_2d.png")
mgb.save_solution("solution_2d.npz", sol)
print("wrote solution_2d.png / solution_2d.npz")
