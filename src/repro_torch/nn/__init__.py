"""Layers, attention, feed-forward and transformer blocks."""
