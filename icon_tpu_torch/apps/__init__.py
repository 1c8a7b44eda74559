"""Command-line applications of the port (the demo CLI and the geometry
trainer)."""
