"""Isosurface extraction of the learned SDF (``marching_cubes.py``)."""
