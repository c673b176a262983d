"""Checkpoints of the port: async, atomic, with retention."""
