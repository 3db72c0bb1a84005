"""Jax-free utilities the port keeps its own copies of."""
