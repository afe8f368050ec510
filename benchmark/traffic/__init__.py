"""Traffic of the benchmark (see ``benchmark/harness.py``)."""
