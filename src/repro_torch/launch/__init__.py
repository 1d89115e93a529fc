"""Serving front doors of the port."""
