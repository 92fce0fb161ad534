"""The decoder models of the port: config, layers, attention, the
Mamba-1 SSM block, transformer."""
