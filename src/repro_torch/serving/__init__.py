"""Serving: the static-batching engine of the port."""
