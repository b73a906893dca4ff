"""HuggingFace Hub client: list and download GGUF files, and the local model
cache (port of llama_gguf_tpu/hub.py: the same URLs, headers, cache layout,
printed progress and errors).

Uses the ``huggingface_hub`` library when importable, with a plain-HTTP
fallback (``urllib``); ``HF_TOKEN`` authorizes and ``LLAMA_GGUF_CACHE_DIR``
moves the cache. A file already in the cache is returned without a request,
so the cache works offline.
"""

from __future__ import annotations

import json
import os
import urllib.request
from pathlib import Path

DEFAULT_CACHE_DIR = "~/.cache/llama-gguf-tpu/models"


class HubError(RuntimeError):
    pass


class HubClient:
    def __init__(self, cache_dir: str | None = None, token: str | None = None):
        self.cache_dir = Path(os.path.expanduser(
            cache_dir or os.environ.get("LLAMA_GGUF_CACHE_DIR",
                                        DEFAULT_CACHE_DIR)))
        self.token = token or os.environ.get("HF_TOKEN")

    # -- remote ----------------------------------------------------------------

    def list_gguf_files(self, repo_id: str) -> list[str]:
        """List *.gguf files in a Hub repo."""
        try:
            from huggingface_hub import HfApi

            files = HfApi(token=self.token).list_repo_files(repo_id)
            return sorted(f for f in files if f.endswith(".gguf"))
        except ImportError:
            pass
        url = f"https://huggingface.co/api/models/{repo_id}"
        try:
            with urllib.request.urlopen(self._request(url), timeout=30) as r:
                data = json.load(r)
        except Exception as e:
            raise HubError(f"cannot reach HuggingFace Hub: {e}") from e
        return sorted(s["rfilename"] for s in data.get("siblings", [])
                      if s["rfilename"].endswith(".gguf"))

    def download(self, repo_id: str, filename: str,
                 progress: bool = True) -> str:
        """Download one file into the cache dir; returns the local path.
        Skips the download if the file is already cached."""
        target_dir = self.cache_dir / repo_id.replace("/", "--")
        target = target_dir / os.path.basename(filename)
        if target.exists() and target.stat().st_size > 0:
            return str(target)
        target_dir.mkdir(parents=True, exist_ok=True)
        try:
            from huggingface_hub import hf_hub_download

            path = hf_hub_download(repo_id, filename, token=self.token,
                                   local_dir=str(target_dir))
            return str(path)
        except ImportError:
            pass
        except Exception as e:
            raise HubError(f"download failed: {e}") from e
        url = f"https://huggingface.co/{repo_id}/resolve/main/{filename}"
        tmp = str(target) + ".part"
        try:
            with urllib.request.urlopen(self._request(url), timeout=60) as r, \
                    open(tmp, "wb") as f:
                total = int(r.headers.get("Content-Length") or 0)
                done = 0
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    done += len(chunk)
                    if progress and total:
                        pct = 100 * done / total
                        print(f"\r{filename}: {pct:5.1f}% "
                              f"({done / 1e6:.0f}/{total / 1e6:.0f} MB)",
                              end="", flush=True)
            if progress:
                print()
            os.replace(tmp, target)
        except Exception as e:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise HubError(f"download failed: {e}") from e
        return str(target)

    def search(self, query: str, limit: int = 20) -> list[str]:
        """Search Hub for GGUF model repos (needs huggingface_hub)."""
        try:
            from huggingface_hub import HfApi

            models = HfApi(token=self.token).list_models(
                search=query, filter="gguf", limit=limit)
            return [m.id for m in models]
        except ImportError as e:
            raise HubError(f"search requires huggingface_hub: {e}") from e
        except Exception as e:
            raise HubError(f"search failed: {e}") from e

    def _request(self, url: str):
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return req

    # -- local -------------------------------------------------------------------

    def list_local_models(self) -> list[tuple[str, int]]:
        """All cached .gguf files as (path, size_bytes), newest first."""
        if not self.cache_dir.exists():
            return []
        return [(str(p), p.stat().st_size)
                for p in sorted(self.cache_dir.rglob("*.gguf"),
                                key=lambda p: -p.stat().st_mtime)]

    def evict(self, path: str) -> None:
        p = Path(path)
        if self.cache_dir in p.parents and p.exists():
            p.unlink()
