"""Shared runtime helpers: Prometheus-style metrics and atomic publish."""
