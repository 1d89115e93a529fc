"""Losses, the optimizer and the train step of the port (``repro.train``)."""
