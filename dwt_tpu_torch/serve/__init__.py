"""Serving: micro-batcher, bucketed engine, HTTP front end."""
