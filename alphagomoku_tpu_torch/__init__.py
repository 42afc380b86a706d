"""PyTorch/CUDA port of the alphagomoku_tpu package for NVIDIA Hopper GPUs."""
