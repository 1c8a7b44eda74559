"""Command-line applications of the port (the demo CLI)."""
