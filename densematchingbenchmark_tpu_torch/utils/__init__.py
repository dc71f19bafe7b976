"""Utilities of the port."""

from .jax_weights import flax_variables, load_jax_variables

__all__ = ["flax_variables", "load_jax_variables"]
