"""Finite-difference, vorticity and integral operators, and the fused
vorticity-step kernel wrapper."""
