"""Annotation-cache key helper shared by the dataset adapters (the JAX
package's ``data/cacheutil.py``, kept as the port's own copy).

The reference keys its annotation caches only by split parameters
(obman.py:143-150, fhbhands.py:~200, stereohands.py), but the cached
annotations embed absolute file paths — a same-named split under a
*different* root (test fixtures, fabricated trees, relocated data)
would silently serve another tree's paths.  Every adapter therefore
appends ``root_cache_tag(root)`` to its cache filename.
"""

from __future__ import annotations

import hashlib
import os


def root_cache_tag(root: str) -> str:
    """Short stable tag identifying the dataset root a cache was built
    from (hash of the absolute path, not the contents — same trade-off
    as the reference: a changed tree under the same path still needs
    ``use_cache=False`` or a cleared cache folder)."""
    return hashlib.sha1(os.path.abspath(root).encode()).hexdigest()[:10]
