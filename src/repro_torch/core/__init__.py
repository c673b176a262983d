"""Quantization core of the port: conventions, decomposition, packing."""
