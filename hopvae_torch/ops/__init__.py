"""Hopfield ops, conv helpers and the straight-through round."""
