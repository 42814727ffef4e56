"""Tensor ops of the port: the mel front end (plain and CUDA kernel) and
the device detokenizer."""
