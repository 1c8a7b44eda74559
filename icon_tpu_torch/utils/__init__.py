"""Synthetic fields and weight conversion for the port."""
