"""Plain NumPy and PyTorch references of what the benchmark's cells run.

Nothing here imports the program under test: each module follows the published
description of its model or format, computes in float32 (float64 for the image
codec) with TF32 off, and takes its inputs and weights from the benchmark.
"""
