"""Utilities of the port: the image quality metrics (metrics.py)."""
