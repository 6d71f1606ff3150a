"""Checkpoint I/O of the port."""
