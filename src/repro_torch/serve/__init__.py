"""Serving: continuous batching and decoding of token requests, and slot
scheduling for the conv serving tier."""
