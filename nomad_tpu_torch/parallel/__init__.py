"""Sharding of the solver over a grid of cells (parallel/mesh.py)."""
