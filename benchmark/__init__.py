"""The benchmark of fullysparsefusion_tpu_torch (see run.py)."""
