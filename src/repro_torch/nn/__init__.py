"""Layers of the port (``nn.Module``s on the blocked layouts)."""
