"""Remote and local storage (counterpart of clip_fsar_tpu/utils/storage.py:31-147,
the reference's utils/bucket.py: OSS download and upload with retries).

A URL-scheme registry: ``file://`` and bare paths work everywhere;
``oss://`` and ``gs://`` backends register themselves when their SDKs
(oss2, google-cloud-storage) import, and ``register_scheme`` adds others.
Every fetch retries as the reference does and lands in a local cache
directory (``CLIP_FSAR_CACHE``, else ``clip_fsar_cache`` under the
process's temporary directory).  The checkpoint loaders fetch remote paths
through it (train/pretrain.py).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional
from urllib.parse import urlparse

from clip_fsar_torch.utils.logging import get_logger

logger = get_logger(__name__)

_FETCHERS: Dict[str, Callable[[str, str], None]] = {}
_UPLOADERS: Dict[str, Callable[[str, str], None]] = {}

RETRIES = 3
CACHE_DIR = os.environ.get("CLIP_FSAR_CACHE", os.path.join(tempfile.gettempdir(), "clip_fsar_cache"))


def register_scheme(scheme: str, fetch: Callable[[str, str], None], upload: Optional[Callable[[str, str], None]] = None) -> None:
    _FETCHERS[scheme] = fetch
    if upload is not None:
        _UPLOADERS[scheme] = upload


def _fetch_file(url: str, dst: str) -> None:
    src = url[len("file://"):] if url.startswith("file://") else url
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copy2(src, dst)


register_scheme("file", _fetch_file)


def _try_register_oss() -> None:
    try:
        import oss2
    except ImportError:
        return
    if getattr(oss2, "__parity_stub__", False):  # test-harness stub, not the SDK
        return

    def fetch(url: str, dst: str) -> None:
        # oss://bucket/key — credentials from OSS_KEY/OSS_SECRET/OSS_ENDPOINT
        import oss2

        p = urlparse(url)
        auth = oss2.Auth(os.environ["OSS_KEY"], os.environ["OSS_SECRET"])
        bucket = oss2.Bucket(auth, os.environ["OSS_ENDPOINT"], p.netloc)
        bucket.get_object_to_file(p.path.lstrip("/"), dst)

    def upload(src: str, url: str) -> None:
        import oss2

        p = urlparse(url)
        auth = oss2.Auth(os.environ["OSS_KEY"], os.environ["OSS_SECRET"])
        bucket = oss2.Bucket(auth, os.environ["OSS_ENDPOINT"], p.netloc)
        bucket.put_object_from_file(p.path.lstrip("/"), src)

    register_scheme("oss", fetch, upload)


def _try_register_gcs() -> None:
    try:
        from google.cloud import storage  # noqa: F401
    except ImportError:
        return

    def fetch(url: str, dst: str) -> None:
        from google.cloud import storage

        p = urlparse(url)
        storage.Client().bucket(p.netloc).blob(p.path.lstrip("/")).download_to_filename(dst)

    def upload(src: str, url: str) -> None:
        from google.cloud import storage

        p = urlparse(url)
        storage.Client().bucket(p.netloc).blob(p.path.lstrip("/")).upload_from_filename(src)

    register_scheme("gs", fetch, upload)


_try_register_oss()
_try_register_gcs()


def is_remote(path: str) -> bool:
    scheme = urlparse(path).scheme
    return scheme not in ("", "file") and len(scheme) > 1  # len>1 excludes windows drives


def fetch(path: str, local_path: Optional[str] = None) -> str:
    """Materialize ``path`` locally (retrying like reference
    bucket.py:26-35) and return the local filename.  Local paths are
    returned unchanged."""
    if not is_remote(path):
        return path[len("file://"):] if path.startswith("file://") else path
    scheme = urlparse(path).scheme
    if scheme not in _FETCHERS:
        raise ValueError(
            f"no storage backend registered for {scheme}:// — install its SDK "
            f"or register_scheme(); known: {sorted(_FETCHERS)}"
        )
    if local_path is None:
        os.makedirs(CACHE_DIR, exist_ok=True)
        local_path = os.path.join(CACHE_DIR, os.path.basename(urlparse(path).path) or "blob")
    err: Optional[Exception] = None
    for attempt in range(RETRIES):
        try:
            _FETCHERS[scheme](path, local_path)
            return local_path
        except Exception as e:  # noqa: BLE001 — retry any backend error
            err = e
            logger.warning("fetch %s failed (attempt %d/%d): %s", path, attempt + 1, RETRIES, e)
            time.sleep(0.5 * (attempt + 1))
    raise RuntimeError(f"failed to fetch {path} after {RETRIES} attempts") from err


def upload(local_path: str, path: str) -> None:
    """Upload a local file to a remote URL (reference put_to_bucket)."""
    if not is_remote(path):
        dst = path[len("file://"):] if path.startswith("file://") else path
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.copy2(local_path, dst)
        return
    scheme = urlparse(path).scheme
    if scheme not in _UPLOADERS:
        raise ValueError(f"no upload backend for {scheme}://")
    _UPLOADERS[scheme](local_path, path)


def clear_tmp_file(local_path: str) -> None:
    """Remove a fetched temp file (reference clear_tmp_file)."""
    if local_path.startswith(CACHE_DIR) and os.path.exists(local_path):
        os.remove(local_path)
