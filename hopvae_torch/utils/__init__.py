"""Checkpoint bridge and the CUDA build helper."""
