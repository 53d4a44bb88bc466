"""Checkpointing (port of ``repro.checkpoint``): deterministic
step-indexed save and restore with manifests, atomic installs and content
digests; the files cross-restore with the JAX package's. Names are
imported on first use.
"""

from repro_torch._exports import lazy

_ST = "repro_torch.checkpoint.store"
__getattr__ = lazy(__name__, {
    name: (_ST, name) for name in (
        "CheckpointCorruption", "all_steps", "latest_step", "restore",
        "restore_latest_valid", "save")
})
