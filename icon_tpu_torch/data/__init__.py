"""Inputs of the demo: the in-the-wild photo dataset and the demo's calib."""
