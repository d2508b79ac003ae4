"""Synthetic data for the CNN path."""
