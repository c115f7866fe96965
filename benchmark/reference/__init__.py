"""Frozen copy of the program's FSF path in plain PyTorch: the benchmark's
reference. It imports nothing of the program, of JAX or of the JAX package."""
