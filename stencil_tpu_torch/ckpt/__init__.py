"""Crash-safe checkpoints of grid state, in the JAX package's format.

- :mod:`snapshot`: per-block snapshots with a JSON manifest, the rename
  protocol, ``LATEST`` and retention; the asynchronous writer.
- :mod:`restore`: validation, auto-resume, quarantine and global
  reassembly.

The campaign driver keeps each tenant's snapshots here; a snapshot written
by either package restores bit for bit in the other.
"""

from .snapshot import (  # noqa: F401
    LATEST_NAME,
    AsyncCheckpointer,
    host_snapshot,
    MANIFEST_NAME,
    MANIFEST_VERSION,
    list_snapshots,
    prune,
    read_latest,
    snapshot_name,
    step_of,
    write_snapshot,
)
from .restore import (  # noqa: F401
    QUARANTINE_PREFIX,
    assemble_global,
    check_compatible,
    find_resume,
    load_manifest,
    quarantine_snapshot,
    validate_manifest,
    validate_snapshot,
)
