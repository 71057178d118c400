"""Content-addressed KV page cache (DESIGN.md §12): page-granular content
and chain hashing, a refcounted shared pool over the KV slow store, and
prefix / interior-substring admission matching for ``serve.sched``."""
from repro_torch.cache.store import KVReuseStore, MatchResult, hash_pages

__all__ = ["KVReuseStore", "MatchResult", "hash_pages"]
