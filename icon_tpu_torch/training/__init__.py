"""The geometry trainer: the optimizer and step, checkpoints, logging and
the prediction panels."""
