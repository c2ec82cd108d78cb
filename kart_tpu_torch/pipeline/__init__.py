"""Chunk mapper and conquer hooks of the port."""
