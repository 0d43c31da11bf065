"""PyTorch/CUDA port of the InferCept serving stack (see README.md)."""
