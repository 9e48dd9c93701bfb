"""Content-addressed delta checkpoints (``--ckpt_format delta``) — the port of ``dwt_tpu.ckpt``.

``store.py`` holds the subsystem: the blob store, delta manifests chained
to a full save, chain validation, blob GC, and the reads of the port's
and the JAX package's chains.
"""

from dwt_tpu_torch.ckpt.store import (
    BLOBS_DIR,
    DEFAULT_DELTA_MAX_CHAIN,
    GC_MIN_AGE_S,
    ResolvedChain,
    blob_store_root,
    cas_invalid_reason,
    gc_blobs,
    promote_delta,
    resolve_leaves,
    restore_cas_tree,
    save_delta,
    stage_delta,
    tree_bytes,
)

__all__ = [
    "BLOBS_DIR",
    "DEFAULT_DELTA_MAX_CHAIN",
    "GC_MIN_AGE_S",
    "ResolvedChain",
    "blob_store_root",
    "cas_invalid_reason",
    "gc_blobs",
    "promote_delta",
    "resolve_leaves",
    "restore_cas_tree",
    "save_delta",
    "stage_delta",
    "tree_bytes",
]
