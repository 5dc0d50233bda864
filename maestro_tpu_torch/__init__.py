"""PyTorch/CUDA port of maestro_tpu (NVIDIA Hopper)."""
