"""Smoothers, grid transfers and geometric multigrid."""
