"""Source/config provenance backup (port of ``copenerf_tpu/utils/backup.py``).

Mirrors the reference's ``backup`` helper (``model/common.py:470-484``),
which copies the config and the source tree into the run directory so every
experiment records the exact code it ran.
"""

from __future__ import annotations

import os
import shutil

# Build outputs, not sources: the kernels' and the mesher's builds
# (``_build/``), bytecode, libraries and objects.
IGNORE = ("_build", "__pycache__", "*.so", "*.o")


def backup(out_dir: str, cfg_path: str | None = None,
           package_root: str | None = None) -> str:
    """Copy the copenerf_torch package sources (the CUDA and C++ sources
    included) and the scene config into ``out_dir/backup``. Returns the
    backup directory path."""
    dst = os.path.join(out_dir, "backup")
    os.makedirs(dst, exist_ok=True)
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
    pkg_dst = os.path.join(dst, os.path.basename(package_root))
    if os.path.exists(pkg_dst):
        shutil.rmtree(pkg_dst)
    shutil.copytree(package_root, pkg_dst,
                    ignore=shutil.ignore_patterns(*IGNORE))
    if cfg_path is not None and os.path.isfile(cfg_path):
        shutil.copy(cfg_path, dst)
    return dst
