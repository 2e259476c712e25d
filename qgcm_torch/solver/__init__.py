"""Spectral modified-Helmholtz solvers for the PV inversion."""
