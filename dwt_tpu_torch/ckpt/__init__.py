"""Content-addressed delta checkpoints (``--ckpt_format delta``) — the port of ``dwt_tpu.ckpt``.

``store.py`` holds the subsystem: the blob store, delta manifests chained
to a full save, the saves and the reads of the port's and the JAX
package's chains.  ``layout.py`` holds what reads the formats without
torch: manifests, validity, chain resolution and blob GC.  The names are
exported lazily (:func:`~dwt_tpu_torch._lazy.lazy_exports`): the sweep
supervisor imports ``layout`` and must not import torch.
"""

from dwt_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "BLOBS_DIR": "layout",
    "GC_MIN_AGE_S": "layout",
    "ResolvedChain": "layout",
    "cas_invalid_reason": "layout",
    "gc_blobs": "layout",
    "resolve_leaves": "layout",
    "DEFAULT_DELTA_MAX_CHAIN": "store",
    "blob_store_root": "store",
    "promote_delta": "store",
    "restore_cas_tree": "store",
    "save_delta": "store",
    "stage_delta": "store",
    "tree_bytes": "store",
}

__all__ = sorted(_EXPORTS)

__getattr__ = lazy_exports(__name__, _EXPORTS)
