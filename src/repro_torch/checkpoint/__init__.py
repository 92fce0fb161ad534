"""npz checkpoints in the JAX package's file format (see :mod:`.ckpt`)."""
from .ckpt import (MANIFEST, latest_step, load_checkpoint,  # noqa: F401
                   read_manifest, save_checkpoint)
