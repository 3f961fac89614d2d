"""Decode and augmentation ops, and the CUDA kernel wrappers."""
