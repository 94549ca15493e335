"""Harnesses that drive the port's layers end to end."""
