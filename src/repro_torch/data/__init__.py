"""Sharded synthetic LM data and the LM objective."""
