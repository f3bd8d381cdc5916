"""Serving front-ends."""
