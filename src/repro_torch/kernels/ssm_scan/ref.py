"""Plain oracle of the selective scan.

Counterpart of ``src/repro/kernels/ssm_scan/ref.py``: it re-exports the
model layer's reference implementation, so the kernel and the model share
one oracle."""
from ...models.ssm import selective_scan_ref

__all__ = ["selective_scan_ref"]
