"""Synthetic data sets of the port."""
