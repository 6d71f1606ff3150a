"""Host-side image decode: OpenCV (libjpeg-turbo) first, then PIL, on a
thread pool. Counterpart of ``vip_cup_2022_tpu/data/decode.py``; both
decoders release the interpreter lock while they decode."""
from __future__ import annotations

import concurrent.futures as _fut
from typing import List, Sequence

import numpy as np

try:
    import cv2

    cv2.setNumThreads(0)  # parallel at the image level instead
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def decode_image(path: str) -> np.ndarray:
    """Decode one image file to uint8 HWC RGB."""
    if _HAS_CV2:
        buf = np.fromfile(path, dtype=np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)  # BGR
        if img is not None:
            return img[:, :, ::-1]
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageDecoder:
    """Thread pool of image decoders."""

    def __init__(self, num_threads: int = 16):
        self._pool = _fut.ThreadPoolExecutor(max_workers=num_threads)

    def decode_batch(self, paths: Sequence[str]) -> List[np.ndarray]:
        return list(self._pool.map(decode_image, paths))

    def submit_batch(self, paths: Sequence[str], postprocess=None):
        """Decode a chunk asynchronously: one pool task per image, returning
        the futures. ``postprocess`` (e.g. the host resize) runs inside the
        worker, so the consumer only gathers finished arrays."""
        if postprocess is None:
            return [self._pool.submit(decode_image, p) for p in paths]
        return [self._pool.submit(lambda p=p: postprocess(decode_image(p))) for p in paths]

    def map(self, fn, *iterables) -> list:
        """``fn`` over the items on the pool, the results in order."""
        return list(self._pool.map(fn, *iterables))

    def close(self):
        self._pool.shutdown(wait=False)
