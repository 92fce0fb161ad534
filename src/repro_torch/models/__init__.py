"""The dense decoder of ``rfast-100m``: config, layers, attention,
transformer."""
