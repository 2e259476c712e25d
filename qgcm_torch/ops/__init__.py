"""Finite-difference, vorticity and integral operators, and the fused
vorticity-step kernel wrapper."""

from .integrals import xintp_weights, xintp, xintt  # noqa: F401
