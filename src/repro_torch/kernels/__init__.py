"""Hand-written Hopper kernels and their build (``_build.py``)."""
