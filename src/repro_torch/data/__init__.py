"""Data pipeline of the port: the byte-level corpus and token batches."""
