"""Serving engine: a model deployed on the platform as a function chain."""
