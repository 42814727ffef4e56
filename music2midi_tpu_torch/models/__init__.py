"""The T5 encoder-decoder of the port."""
