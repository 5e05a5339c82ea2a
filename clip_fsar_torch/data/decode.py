"""Host-side video decode backends (copy of clip_fsar_tpu/data/decode.py:24-324).

The reference decodes with decord (C++/FFmpeg, datasets/base/base_dataset.py
:210-280).  This package needs none of decord, PyAV or ffmpeg: it decodes with OpenCV (and its
bundled codecs).  Decoders are registered so sites with other
stacks can plug in.

Contract: a decoder exposes ``length(path) -> int`` and
``read(path, indices) -> uint8 [len(indices), H, W, 3]`` (RGB).  Frame
selection stays on the host; resize/crop happen downstream.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from clip_fsar_torch.utils.registry import DECODER_REGISTRY


@DECODER_REGISTRY.register(name="synthetic")
class SyntheticDecoder:
    """Deterministic procedural video derived from the path hash.

    Each class of synthetic motion is keyed by the path, so golden tests
    and benchmarks get stable, non-trivial inputs with zero I/O.
    """

    def __init__(self, height: int = 128, width: int = 160, min_len: int = 40, max_len: int = 120):
        self.height, self.width = height, width
        self.min_len, self.max_len = min_len, max_len

    def _seed(self, path: str) -> int:
        return int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")

    def length(self, path: str) -> int:
        return self.min_len + self._seed(path) % (self.max_len - self.min_len)

    def read(self, path: str, indices: Sequence[int]) -> np.ndarray:
        seed = self._seed(path)
        rng = np.random.RandomState(seed)
        base = rng.randint(0, 256, size=(self.height, self.width, 3)).astype(np.uint8)
        vx, vy = int(rng.randint(1, 6)), int(rng.randint(1, 6))
        out = np.empty((len(indices), self.height, self.width, 3), dtype=np.uint8)
        for i, t in enumerate(indices):
            frame = base.copy()
            # a moving bright square gives the frames temporal structure
            y = (vy * int(t) * 4) % (self.height - 24)
            x = (vx * int(t) * 4) % (self.width - 24)
            frame[y : y + 24, x : x + 24] = 255 - (seed % 128)
            out[i] = frame
        return out


@DECODER_REGISTRY.register(name="image_folder")
class ImageFolderDecoder:
    """Frames stored as ordered image files in a directory per video."""

    EXTS = (".jpg", ".jpeg", ".png")

    def _files(self, path: str):
        return sorted(f for f in os.listdir(path) if f.lower().endswith(self.EXTS))

    def length(self, path: str) -> int:
        return len(self._files(path))

    def read(self, path: str, indices: Sequence[int]) -> np.ndarray:
        from PIL import Image

        files = self._files(path)
        frames = []
        for t in indices:
            with Image.open(os.path.join(path, files[int(t)])) as im:
                frames.append(np.asarray(im.convert("RGB")))
        return np.stack(frames)


@DECODER_REGISTRY.register(name="opencv")
class OpenCVDecoder:
    """cv2.VideoCapture decode; reads sequentially and keeps wanted frames
    (sequential grab beats per-frame seeking for the near-uniform index
    patterns the samplers produce)."""

    def length(self, path: str) -> int:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        finally:
            cap.release()
        if n <= 0:
            raise IOError(f"Cannot read frame count from {path}")
        return n

    def fps(self, path: str) -> float:
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            return float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        finally:
            cap.release()

    def read(self, path: str, indices: Sequence[int]) -> np.ndarray:
        import cv2

        wanted = sorted(set(int(i) for i in indices))
        cap = cv2.VideoCapture(path)
        got = {}
        try:
            pos = 0
            for target in wanted:
                while pos < target:
                    if not cap.grab():
                        break
                    pos += 1
                ok, frame = cap.read()
                if not ok:
                    break
                pos += 1
                got[target] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        finally:
            cap.release()
        if not got:
            raise IOError(f"Decoded zero frames from {path}")
        last = got[max(got)]
        return np.stack([got.get(int(i), last) for i in indices])


@DECODER_REGISTRY.register(name="cached_opencv")
class CachedVideoDecoder:
    """JPEG frame cache over OpenCVDecoder for the 10k-episode eval
    protocol (reference test_net_few_shot.py:57): the same test videos are
    decoded thousands of times across episodes, and mp4 seek+decode is
    what bounds the host pipeline on small hosts (PERFORMANCE.md "Host
    pipeline").

    First touch of a video decodes up to ``max_frames`` uniformly-spaced
    frames ONCE, JPEG-encodes them (~30 KB/frame vs ~250 KB raw) into one
    .npz next to a metadata record; later reads decode only the requested
    JPEGs (~1 ms/frame, no container parsing).  Requested indices are
    snapped to the nearest cached frame — with the uniform-segment sampler
    (SAMPLING_RATE>40 path) drawing 8 of >=64 positions, the quantization
    is at most half the cache stride.  Opt in with ``DATA.DECODER:
    cached_opencv``; tune ``DATA.FRAME_CACHE_DIR / FRAME_CACHE_FRAMES /
    FRAME_CACHE_JPEG_QUALITY``.
    """

    def __init__(
        self,
        cache_dir: Optional[str] = None,
        max_frames: int = 64,
        jpeg_quality: int = 90,
        lru_videos: int = 64,
    ):
        import collections
        import tempfile
        import threading

        self.inner = OpenCVDecoder()
        self.cache_dir = cache_dir or os.path.join(tempfile.gettempdir(), "clip_fsar_frame_cache")
        self.max_frames = int(max_frames)
        self.jpeg_quality = int(jpeg_quality)
        os.makedirs(self.cache_dir, exist_ok=True)
        # per-path LRU of materialized cache contents: the eval loop calls
        # length()/fps()/read() several times per clip per episode, and a
        # fresh np.load (zip central-directory parse) per call costs more
        # than the JPEG decodes it precedes.  Entries are plain dicts (the
        # NpzFile is drained and closed at insert) so loader THREADS can
        # read them without locking; ~2 MB/video of encoded JPEGs per
        # entry.  The 10k-episode protocol cycles ~1.3k test videos
        # uniformly, so a cap below the split size never warms — size DATA.FRAME_CACHE_LRU_VIDEOS to the split for
        # protocol runs (the decoder is shared across loader workers, so
        # this is one pool, not one per thread)
        self._lru: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._lru_cap = int(lru_videos)
        self._lock = threading.Lock()

    def _cache_path(self, path: str) -> str:
        # key on content identity (path + size + mtime) AND the cache
        # parameters: re-encoded source files and FRAME_CACHE_FRAMES /
        # JPEG-quality changes must miss, not silently reuse stale frames
        try:
            st = os.stat(path)
            sig = f"{path}:{st.st_size}:{int(st.st_mtime)}"
        except OSError:
            sig = path
        # v2: one concatenated JPEG blob + offsets per video.  v1 stored
        # each frame as its own npz entry; np.load then paid a zip header
        # + ast.literal_eval parse PER FRAME on every LRU miss (measured
        # 15 ms/video, 63 % of warm episode assembly on a cold LRU) — the
        # blob form is 5 entries regardless of frame count
        key = hashlib.md5(f"{sig}:{self.max_frames}:{self.jpeg_quality}:v2".encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"{key}.npz")

    def _gc_v1(self, path: str) -> None:
        """Unlink this video's pre-blob (v1, per-frame-entry) cache file if
        one survives — orphaned by the v2 key suffix, never read again, and
        roughly doubling shared FRAME_CACHE_DIRs otherwise."""
        try:
            st = os.stat(path)
            sig = f"{path}:{st.st_size}:{int(st.st_mtime)}"
        except OSError:
            sig = path
        v1 = hashlib.md5(f"{sig}:{self.max_frames}:{self.jpeg_quality}".encode()).hexdigest()[:16]
        try:
            os.unlink(os.path.join(self.cache_dir, f"{v1}.npz"))
        except OSError:
            pass

    def _ensure(self, path: str):
        import cv2

        with self._lock:
            z = self._lru.get(path)
            if z is not None:
                self._lru.move_to_end(path)
                return z

        cpath = self._cache_path(path)
        if os.path.exists(cpath):
            return self._remember(path, np.load(cpath, allow_pickle=False))
        self._gc_v1(path)
        n = self.inner.length(path)
        fps = self.inner.fps(path)
        keep = np.unique(np.linspace(0, n - 1, min(self.max_frames, n)).round().astype(np.int64))
        frames = self.inner.read(path, keep)
        flag = [int(cv2.IMWRITE_JPEG_QUALITY), self.jpeg_quality]
        encs = []
        for i, f in enumerate(frames):
            ok, enc = cv2.imencode(".jpg", cv2.cvtColor(f, cv2.COLOR_RGB2BGR), flag)
            if not ok:
                raise IOError(f"JPEG encode failed for {path} frame {keep[i]}")
            encs.append(np.frombuffer(enc.tobytes(), np.uint8))
        off = np.zeros(len(encs) + 1, np.int64)
        np.cumsum([len(e) for e in encs], out=off[1:])
        blob = {
            "orig_idx": keep,
            "length": np.int64(n),
            "fps": np.float64(fps),
            "jpegs": np.concatenate(encs) if encs else np.zeros(0, np.uint8),
            "off": off,
        }
        # unique tmp per writer (loader THREADS share a pid) + atomic
        # replace: concurrent workers race benignly, last write wins
        import tempfile

        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".npz.tmp")
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **blob)
        os.replace(tmp, cpath)
        return self._remember(path, np.load(cpath, allow_pickle=False))

    def _remember(self, path: str, z) -> dict:
        data = {k: z[k] for k in z.files}
        z.close()
        with self._lock:
            self._lru[path] = data
            self._lru.move_to_end(path)
            while len(self._lru) > self._lru_cap:
                self._lru.popitem(last=False)
        return data

    def length(self, path: str) -> int:
        return int(self._ensure(path)["length"])

    def fps(self, path: str) -> float:
        return float(self._ensure(path)["fps"])

    def read(self, path: str, indices: Sequence[int]) -> np.ndarray:
        import cv2

        z = self._ensure(path)
        orig = z["orig_idx"]
        # snap each requested original index to the nearest cached frame
        pos = np.searchsorted(orig, np.asarray(indices, np.int64))
        pos = np.clip(pos, 0, len(orig) - 1)
        left = np.clip(pos - 1, 0, len(orig) - 1)
        take = np.where(
            np.abs(orig[left] - np.asarray(indices)) <= np.abs(orig[pos] - np.asarray(indices)), left, pos
        )
        jpegs, off = z["jpegs"], z["off"]
        decoded = {}
        for i in np.unique(take):
            i = int(i)
            decoded[i] = cv2.cvtColor(
                cv2.imdecode(jpegs[off[i]:off[i + 1]], cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB
            )
        return np.stack([decoded[int(i)] for i in take])


def build_decoder(name: str, data_root: Optional[str] = None, cfg_data=None):
    """'auto' picks opencv when the data root exists, synthetic otherwise.
    cfg_data (the DATA config node) parameterizes the frame cache."""
    if name == "auto":
        if data_root and os.path.isdir(data_root):
            name = "opencv"
        else:
            name = "synthetic"
    if name == "cached_opencv" and cfg_data is not None and bool(cfg_data.get("EXACT_SAMPLING", False)):
        # accuracy runs compared against the reference protocol must read
        # the EXACT sampled frame indices (reference datasets/base/
        # base_dataset.py:493-530); the cache snaps them to a fixed grid
        raise ValueError(
            "DATA.EXACT_SAMPLING=true refuses DECODER=cached_opencv: the frame "
            "cache snaps sampled indices to its uniform grid, which the "
            "reference decode path never does. Use DATA.DECODER opencv (or "
            "auto) for protocol-exact accuracy runs, or drop EXACT_SAMPLING "
            "for throughput runs where grid quantization is acceptable."
        )
    if name == "cached_opencv" and cfg_data is not None:
        return CachedVideoDecoder(
            cache_dir=cfg_data.get("FRAME_CACHE_DIR", None) or None,
            max_frames=int(cfg_data.get("FRAME_CACHE_FRAMES", 64)),
            jpeg_quality=int(cfg_data.get("FRAME_CACHE_JPEG_QUALITY", 90)),
            lru_videos=int(cfg_data.get("FRAME_CACHE_LRU_VIDEOS", 64)),
        )
    return DECODER_REGISTRY.get(name)()
