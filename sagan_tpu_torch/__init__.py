"""PyTorch and CUDA port of sagan_tpu for NVIDIA Hopper."""
