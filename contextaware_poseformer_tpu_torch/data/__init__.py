"""Serving-input preparation of the port."""
