"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else, so a run can show that its main path went through
the kernels (``chip_smoke.py`` clears the counts, drives the path, and reads
them back).
"""

from __future__ import annotations

import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
