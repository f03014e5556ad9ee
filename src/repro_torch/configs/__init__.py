"""Configurations (copies of the reference's jax-free dataclasses)."""
