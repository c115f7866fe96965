"""PyTorch port of fullysparsefusion_tpu for NVIDIA Hopper GPUs (CUDA kernels in csrc/)."""
