"""The benchmark harness: what run.py drives."""
