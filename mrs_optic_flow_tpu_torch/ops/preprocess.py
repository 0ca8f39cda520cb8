"""On-device image preprocessing (port of :mod:`mrs_optic_flow_tpu.ops.preprocess`).

The reference does this on the host with OpenCV before uploading
(``src/optic_flow.cpp:1602-1622``); here it runs on the frame's device so
only the raw uint8 frame crosses to the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Weights of OpenCV's RGB2GRAY: gray = 0.299 R + 0.587 G + 0.114 B.
_GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def to_grayscale(img: torch.Tensor, *, swap_rb: bool = True) -> torch.Tensor:
    """Channel-weighted grayscale of an ``[..., H, W, 3]`` image (float32).

    ``swap_rb=True`` keeps the reference's quirk: it decodes the frame as
    BGR8 (``src/optic_flow.cpp:1465``) and applies ``CV_RGB2GRAY`` to that
    buffer (``:1622``), so the 0.299 weight lands on the blue channel.
    ``False`` gives the colorimetric conversion of a BGR input.
    """
    w = torch.tensor(_GRAY_WEIGHTS, dtype=torch.float32, device=img.device)
    if not swap_rb:
        w = w.flip(0)
    return torch.tensordot(img.to(torch.float32), w, dims=([-1], [0]))


def quantize_u8(frame: torch.Tensor) -> torch.Tensor:
    """Round (half to even) and saturate to uint8 — the reference's 8U
    pixels.  uint8 input passes through untouched."""
    if frame.dtype == torch.uint8:
        return frame
    return torch.clamp(torch.round(frame.to(torch.float32)), 0, 255).to(torch.uint8)


def center_crop(img: torch.Tensor, frame_size: int, cx: float) -> torch.Tensor:
    """``frame_size``-square crop centred on ``(cx, H/2)``
    (``src/optic_flow.cpp:1610-1618``); a view of ``img``."""
    h, w = img.shape[-2:]
    xi, yi = crop_origin(w, h, frame_size, cx)
    if xi < 0 or yi < 0 or xi + frame_size > w or yi + frame_size > h:
        raise ValueError(f"crop {frame_size}px at ({xi}, {yi}) leaves the {w}x{h} image")
    return img[..., yi : yi + frame_size, xi : xi + frame_size]


def crop_origin(img_width: int, img_height: int, frame_size: int, cx: float) -> tuple:
    """Upper-left corner ``(xi, yi)`` of the crop (``src/optic_flow.cpp:1719``)."""
    return int(cx) - frame_size // 2, img_height // 2 - frame_size // 2


def resize_by(img: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """Bilinear resize of a float ``[..., H, W]`` image by ``1/inv_scale``.

    Antialiased like ``jax.image.resize(..., "linear")``, so that the port
    matches the JAX package (which differs from ``cv::resize`` when
    downsampling; ROADMAP fault F1).
    """
    h, w = img.shape[-2:]
    size = (round(h / inv_scale), round(w / inv_scale))
    x = img.reshape((-1, 1, h, w))
    out = F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(img.shape[:-2] + size)


def patchify(frame: torch.Tensor, patch: int) -> torch.Tensor:
    """``[..., S*q, S*q] -> [..., q*q, S, S]`` with patch order
    ``index = i + q*j`` (``i`` = column patch, ``cl/FftMethod.cl:1407-1409``)."""
    *lead, h, w = frame.shape
    qy, qx = h // patch, w // patch
    x = frame.reshape(*lead, qy, patch, qx, patch)
    x = torch.movedim(x, -2, -3)  # [..., qy, qx, S, S]
    return x.reshape(*lead, qy * qx, patch, patch)


def unpatchify(patches: torch.Tensor, qy: int, qx: int) -> torch.Tensor:
    """Inverse of :func:`patchify` for a ``[..., qy*qx, S, S]`` tensor."""
    *lead, _, s, _ = patches.shape
    x = patches.reshape(*lead, qy, qx, s, s)
    x = torch.movedim(x, -2, -3)
    return x.reshape(*lead, qy * s, qx * s)
