"""Grids, normalization transforms and param-tree helpers."""
