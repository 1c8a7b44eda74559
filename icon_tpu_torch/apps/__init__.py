"""Command-line applications of the port (the demo CLI, the geometry and
NormalNet trainers, the dataset renderer and the TetraSMPL asset
builder)."""
