"""Formats, quantization, packed tensors and precision policies."""
