"""Mamba-1 selective scan: the op and its autograd function (``ops``),
the CUDA kernel's wrapper and plain twin (``kernel``), and the plain
oracle (``ref``, shared with ``models/ssm.py``)."""
