"""Utilities of the port."""

from .jax_weights import load_jax_variables

__all__ = ["load_jax_variables"]
