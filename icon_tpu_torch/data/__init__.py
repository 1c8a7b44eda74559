"""Inputs: the in-the-wild photo dataset, the demo's calib, the geometry
trainer's dataset and loader, the offline renders and the synthetic
fixture."""
