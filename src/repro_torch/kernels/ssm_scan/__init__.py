"""Mamba-1 selective scan: the op and its autograd function (``ops``),
the CUDA kernels' wrappers and plain twins — the forward (``kernel``) and
the backward from its checkpoints (``backward``) — and the plain oracle
(``ref``, shared with ``models/ssm.py``)."""
