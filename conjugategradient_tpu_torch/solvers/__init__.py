"""Convergence policy, CG, multi-RHS CG and mixed-precision refinement."""
