"""Tests of the benchmark (see conftest.py)."""
