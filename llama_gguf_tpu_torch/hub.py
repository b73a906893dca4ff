"""The local model cache (port of llama_gguf_tpu/hub.py, trimmed to what
``models`` needs): the cache directory's default and the listing of the
GGUF files in it. Downloading from the Hub is not ported (it needs the
network).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = "~/.cache/llama-gguf-tpu/models"


def list_local_models(path: str | None = None) -> list[tuple[str, int]]:
    """All cached .gguf files under ``path`` (else $LLAMA_GGUF_CACHE_DIR,
    else DEFAULT_CACHE_DIR) as (path, size_bytes), newest first."""
    root = Path(os.path.expanduser(
        path or os.environ.get("LLAMA_GGUF_CACHE_DIR", DEFAULT_CACHE_DIR)))
    if not root.exists():
        return []
    return [(str(p), p.stat().st_size)
            for p in sorted(root.rglob("*.gguf"),
                            key=lambda p: -p.stat().st_mtime)]
