"""The plain float32 reference and the comparisons that decide ``correct``."""
