"""Entries: how a traffic mix drives the program, a module each, named by
the traffic file's ``entry``; each has ``run(cell, seed, seconds, trace,
device) -> Result``."""
