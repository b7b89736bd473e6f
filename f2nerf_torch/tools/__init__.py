"""Jax-free counterparts of the JAX package's offline scripts:
``eval`` (scripts/eval.py), ``inter_poses`` (scripts/inter_poses.py) and
``pose_utils`` (scripts/poses/pose_utils.py), with the COLMAP readers they
need (``colmap``)."""
