"""Synthetic benchmark studies replicated from the reference pipeline."""
