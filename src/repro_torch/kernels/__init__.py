"""The codec, the backend registries, the paged cache and the CUDA kernels
(``csrc/``) with their plain PyTorch versions."""
