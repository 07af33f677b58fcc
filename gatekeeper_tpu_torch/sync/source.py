"""Cluster object sources: the YAML manifest loader.

``FileSource`` is a one-shot source reading YAML manifests from a
directory or files (offline/demo runs).  The in-memory and live-apiserver
sources of the JAX package are not part of the port yet.
"""

from __future__ import annotations

import os
from typing import Optional

from gatekeeper_tpu_torch.utils.unstructured import gvk_of, load_yaml_file


class FileSource:
    """Read-only source over a manifest directory (gator-style offline)."""

    def __init__(self, *paths: str):
        self.objects: list[dict] = []
        for path in paths:
            if os.path.isdir(path):
                for root, _dirs, files in os.walk(path):
                    for f in sorted(files):
                        if f.endswith((".yaml", ".yml")):
                            self.objects.extend(
                                load_yaml_file(os.path.join(root, f)))
            else:
                self.objects.extend(load_yaml_file(path))

    def list(self, gvk: Optional[tuple] = None) -> list:
        return [o for o in self.objects
                if gvk is None or gvk_of(o) == gvk]
