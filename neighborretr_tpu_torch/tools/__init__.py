"""Measurement scripts for the port's kernels, run by hand on a card."""
