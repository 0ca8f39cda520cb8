"""Flow-overlay rendering — the headless replacement for the GUI window and
video writer (``src/FftMethod.cpp:1859-1897``, ``cv::line`` overlays with 5x
exaggeration at ``:1861``; window setup ``src/optic_flow.cpp:918-924``).
The port's own copy of :mod:`mrs_optic_flow_tpu.runtime.viz` (numpy only;
the port imports nothing of the JAX package): the same overlay pixels and
the same AVI and PGM bytes.
"""

from __future__ import annotations

import numpy as np


def _draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, value: int):
    """Bresenham line, clipped to the image."""
    h, w = img.shape
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    x, y = x0, y0
    for _ in range(4 * (dx - dy) + 1):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = value
        if x == x1 and y == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x += sx
        if e2 <= dx:
            err += dx
            y += sy
    return img


def flow_overlay(
    frame: np.ndarray,
    shifts: np.ndarray,
    patch: int,
    *,
    exaggeration: float = 5.0,
    scale: float = 1.0,
    value: int = 255,
) -> np.ndarray:
    """Draw per-window flow vectors from each window centre, 5x exaggerated
    like the reference GUI (``src/FftMethod.cpp:1859-1864``).  Invalid (NaN)
    windows are skipped (the reference draws them thin; skipping reads
    better in a still image).  ``scale`` converts the shifts into this
    frame's pixels first — the long-range path measures shifts on the
    ratio-downsampled image (the reference draws on that smaller image, so
    its vectors are ratio-times longer relative to frame size)."""
    img = np.asarray(frame, np.float32).copy()
    img = np.clip(img, 0, 255).astype(np.uint8)
    shifts = np.asarray(shifts).reshape(-1, 2) * scale
    # grid side from the shift count (block-matching engines emit a single
    # aggregated vector; the FFT engine a qxq grid); the passed patch is
    # honored when it tiles this frame exactly, else derived — a single
    # aggregated vector draws from the frame centre either way
    q = max(int(round(len(shifts) ** 0.5)), 1)
    if patch is None or q * patch != frame.shape[0]:
        patch = frame.shape[0] // q
    for j in range(q):
        for i in range(q):
            s = shifts[i + q * j]
            if not np.all(np.isfinite(s)):
                continue
            x0 = i * patch + patch // 2
            y0 = j * patch + patch // 2
            _draw_line(
                img, x0, y0,
                int(x0 + s[0] * exaggeration), int(y0 + s[1] * exaggeration), value,
            )
    return img


class VideoWriter:
    """Minimal dependency-free AVI video writer — the file-output analogue of
    the reference's ``cv::VideoWriter`` (opened at ``src/FftMethod.cpp:1697``
    with the MPEG fourcc, fed the overlay at ``:1895-1897``).  Writes
    uncompressed BGR24 frames (``BI_RGB``) in a standard RIFF/AVI container,
    readable by OpenCV/ffmpeg/VLC; grayscale input is expanded to BGR.

    The trade (uncompressed vs MPEG) is deliberate: no codec dependency, and
    exact pixels for debugging — the conformance test reads the file back
    with ``cv2.VideoCapture`` and asserts bit-equality.
    """

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        if width % 4:
            # BGR24 rows are 3*width bytes; AVI rows pad to 4-byte multiples.
            # Keeping width % 4 == 0 keeps rows unpadded (frame sizes here are
            # even multiples of the patch size, so this never triggers on the
            # reference geometry).
            raise ValueError("AVI BGR24 writer requires width % 4 == 0")
        self.path = path
        self.width = int(width)
        self.height = int(height)
        self.fps = float(fps)
        self._n = 0
        self._index = []  # (offset_in_movi, size) per frame
        self._movi_bytes = 0  # running chunk-byte total inside 'movi'
        self._f = open(path, "wb")
        self._write_header_placeholder()

    def _fourcc(self, s: str) -> bytes:
        return s.encode("ascii")

    def _u32(self, v: int) -> bytes:
        return int(v).to_bytes(4, "little", signed=False)

    def _write_header_placeholder(self):
        import struct

        f = self._f
        w, h = self.width, self.height
        frame_bytes = w * h * 3
        usec = int(round(1e6 / self.fps)) if self.fps > 0 else 0
        # sizes patched in close(): RIFF size, avih dwTotalFrames,
        # strh dwLength, movi LIST size
        f.write(self._fourcc("RIFF") + self._u32(0) + self._fourcc("AVI "))
        # hdrl LIST: avih(56) + strl LIST(strh 56 + strf 40)
        hdrl = b"".join([
            self._fourcc("avih"), self._u32(56),
            struct.pack(
                "<14I",
                usec,                      # dwMicroSecPerFrame
                int(frame_bytes * self.fps),  # dwMaxBytesPerSec
                0,                         # dwPaddingGranularity
                0x10,                      # dwFlags = AVIF_HASINDEX
                0,                         # dwTotalFrames (patched)
                0, 1,                      # dwInitialFrames, dwStreams
                frame_bytes,               # dwSuggestedBufferSize
                w, h, 0, 0, 0, 0,          # width, height, reserved[4]
            ),
        ])
        strh = struct.pack(
            "<4s4sIHHIIIIIIiI4H",
            b"vids", b"DIB ",
            0, 0, 0, 0,                    # dwFlags, wPriority, wLanguage, dwInitialFrames
            1000,                          # dwScale
            int(round(self.fps * 1000)),   # dwRate (fps = rate/scale)
            0, 0,                          # dwStart, dwLength (patched)
            frame_bytes,                   # dwSuggestedBufferSize
            -1,                            # dwQuality
            0,                             # dwSampleSize
            0, 0, w, h,                    # rcFrame
        )
        strf = struct.pack(
            "<IiiHHIIiiII",
            40, w, -h,                     # biSize, biWidth, biHeight (<0 = top-down;
            #                                bottom-up is equally valid AVI but some
            #                                ffmpeg builds heap-corrupt on their
            #                                vertical-flip path — top-down avoids it)
            1, 24,                         # biPlanes, biBitCount
            0,                             # biCompression = BI_RGB
            frame_bytes, 0, 0, 0, 0,
        )
        strl = (self._fourcc("LIST") + self._u32(4 + 8 + len(strh) + 8 + len(strf))
                + self._fourcc("strl")
                + self._fourcc("strh") + self._u32(len(strh)) + strh
                + self._fourcc("strf") + self._u32(len(strf)) + strf)
        hdrl_body = hdrl + strl
        f.write(self._fourcc("LIST") + self._u32(4 + len(hdrl_body))
                + self._fourcc("hdrl") + hdrl_body)
        self._movi_list_pos = f.tell()
        f.write(self._fourcc("LIST") + self._u32(0) + self._fourcc("movi"))

    def write(self, frame: np.ndarray):
        """Append one frame: ``[H, W]`` grayscale or ``[H, W, 3]`` BGR uint8."""
        img = np.asarray(frame)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape != (self.height, self.width, 3):
            raise ValueError(
                f"frame shape {img.shape} != ({self.height}, {self.width}, 3)"
            )
        payload = img.tobytes()  # top-down row order (negative biHeight)
        offset = self._f.tell() - (self._movi_list_pos + 8)
        self._f.write(self._fourcc("00db") + self._u32(len(payload)) + payload)
        self._index.append((offset, len(payload)))
        self._movi_bytes += 8 + len(payload)
        self._n += 1
        # patch the header after EVERY frame so the file is valid even if the
        # process dies without close() — the node records indefinitely and the
        # reference's cv::VideoWriter has the same crash-robustness problem;
        # four tiny seeks per frame are noise next to the 691 KB payload
        self._patch_sizes(self._f.tell())
        self._f.seek(0, 2)

    def _patch_sizes(self, end: int):
        f = self._f
        f.seek(4)
        f.write(self._u32(end - 8))                      # RIFF size
        f.seek(self._movi_list_pos + 4)
        # running total, not a sum over the index — the header is patched
        # after EVERY frame and a per-frame O(frames) walk turns a long
        # recording quadratic
        movi_end = min(end, self._movi_list_pos + 12 + self._movi_bytes)
        f.write(self._u32(movi_end - (self._movi_list_pos + 8)))  # movi size
        f.seek(32 + 16)                                  # avih dwTotalFrames
        f.write(self._u32(self._n))
        # strh payload starts at 32 (avih payload) + 56 + LIST(8) + 'strl'(4)
        # + 'strh'+size(8) = 108; dwLength sits 32 bytes in
        f.seek(108 + 32)
        f.write(self._u32(self._n))

    def close(self):
        if self._f is None:
            return
        f = self._f
        f.seek(0, 2)
        # idx1: one entry per frame, offsets relative to the 'movi' fourcc
        f.write(self._fourcc("idx1") + self._u32(16 * len(self._index)))
        for off, size in self._index:
            f.write(self._fourcc("00db") + self._u32(0x10)  # AVIIF_KEYFRAME
                    + self._u32(off) + self._u32(size))
        self._patch_sizes(f.tell())
        f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_pgm(path: str, img: np.ndarray):
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def load_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        w, h = map(int, f.readline().split())
        maxv = int(f.readline())
        data = np.frombuffer(f.read(), np.uint8, count=w * h)
    return data.reshape(h, w)
