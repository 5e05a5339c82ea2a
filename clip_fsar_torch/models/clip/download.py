"""Pinned-checksum lookup of the OpenAI CLIP checkpoint zoo (counterpart of
clip_fsar_tpu/models/clip/download.py:36-101, the reference's
models/base/few_shot.py:232-274 ``_MODELS`` table and ``_download``).

Each URL carries its own SHA256 as its parent path segment, so the
expected digest comes from the URL and a wrong URL can never verify.
``download_clip_weights`` returns a cached file under ``root`` (default
``~/.cache/clip``) when its digest matches, raises when it does not, and
only otherwise fetches the URL; a host without network access places the
file there by hand.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from typing import List, Optional

MODEL_URLS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

DEFAULT_ROOT = os.path.expanduser("~/.cache/clip")


def available_models() -> List[str]:
    """Names in the pinned zoo (reference available_models, few_shot.py:293)."""
    return list(MODEL_URLS.keys())


def _sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def download_clip_weights(name: str, root: Optional[str] = None) -> str:
    """Return a verified local path to the ``name`` checkpoint, downloading
    it if absent.  SHA256 is pinned by the URL's parent path segment
    (reference _download, few_shot.py:246-274)."""
    if name not in MODEL_URLS:
        raise KeyError(f"Unknown CLIP model {name!r}; available: {available_models()}")
    url = MODEL_URLS[name]
    expected = url.split("/")[-2]
    root = root or DEFAULT_ROOT
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))

    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if _sha256_of(target) == expected:
            return target
        raise RuntimeError(
            f"{target} exists but its SHA256 does not match the pinned digest "
            f"{expected}; delete the file to re-download"
        )

    tmp = target + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as src, open(tmp, "wb") as out:
            while True:
                buf = src.read(1 << 20)
                if not buf:
                    break
                out.write(buf)
    except OSError as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"Cannot download {name} ({url}): {e}. If this host has no "
            f"network access, place the file at {target} manually."
        ) from e
    if _sha256_of(tmp) != expected:
        os.remove(tmp)
        raise RuntimeError(f"Downloaded {name} but the SHA256 checksum does not match {expected}")
    os.replace(tmp, target)
    return target


def load_clip(name: str, root: Optional[str] = None):
    """Locate (or download) and convert an OpenAI checkpoint: returns
    ``(CLIPArch, state dict)`` in the port's names (models/clip/convert.py)."""
    from clip_fsar_torch.models.clip.convert import load_openai_checkpoint

    return load_openai_checkpoint(download_clip_weights(name, root))
