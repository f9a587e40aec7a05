"""Convergence policy and the CG solver."""
