"""Batched SAD block matching, methods 3 and 5 of the reference, in plain
PyTorch.

Port of :mod:`mrs_optic_flow_tpu.ops.block_matching`: the exhaustive
+-scan_radius SAD search per grid cell (``src/BlockMethod.cpp:25-147``,
``src/FastSpacedBMMethod.cl:4-169``), histogram voting over the per-cell
winners, and the iterative 2x-upsample sub-pixel refinement.
:func:`sad_search` is the plain twin of kernel C
(:func:`mrs_optic_flow_tpu_torch.ops.cuda_kernels.sad_search`).  Everything
here stays on the frames' device: no value is read back to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def extract_blocks(frame: torch.Tensor, origins: np.ndarray, size: int) -> torch.Tensor:
    """``[G, size, size]`` blocks of ``frame [..., H, W]`` at the static
    integer origins ``[G, 2]`` (x, y); leading dims come before G.  Origins
    are read as ``lax.dynamic_slice`` reads them: a negative one counts from
    the end, then the block is clamped inside the frame.  (The engines'
    grids never leave the frame.)"""
    h, w = frame.shape[-2:]
    blocks = []
    for x, y in np.asarray(origins):
        y0 = int(np.clip(y + h if y < 0 else y, 0, h - size))
        x0 = int(np.clip(x + w if x < 0 else x, 0, w - size))
        blocks.append(frame[..., y0:y0 + size, x0:x0 + size])
    return torch.stack(blocks, dim=-3)


def sad_search(
    curr_blocks: torch.Tensor,
    prev_regions: torch.Tensor,
    *,
    block_size: int,
    scan_radius: int,
) -> torch.Tensor:
    """SAD maps: ``[G, S, S]`` blocks vs ``[G, S+2R, S+2R]`` search regions
    -> ``[G, D, D]`` float32 sums of absolute differences (D = 2R+1),
    ``SAD[g, i, j]`` comparing the current block with the region rows
    ``i .. i+S`` and columns ``j .. j+S`` (the previous frame shifted by
    ``(j - R, i - R)``).  One row shift at a time, as the JAX ``lax.scan``
    runs it, so the intermediate stays ``[G, S, D, S]``."""
    s, d = block_size, 2 * scan_radius + 1
    curr = curr_blocks.to(torch.float32)
    prev = prev_regions.to(torch.float32)
    rows = []
    for di in range(d):
        # [G, S, D, S]: region rows di .. di+S, every column window of width S
        cols = prev[:, di:di + s, :].unfold(-1, s, 1)
        rows.append(torch.abs(cols - curr[:, :, None, :]).sum(dim=(1, 3)))
    return torch.stack(rows, dim=1)


def sad_min_flow(
    sad: torch.Tensor, scan_radius: int, *, noise_threshold: float | None = None
) -> torch.Tensor:
    """Per-cell integer flow ``[G, 2]`` (x, y) from SAD maps ``[G, D, D]``:
    argmin -> shift in [-R, R], ties to the lowest flat index like
    ``cv::minMaxLoc``.  ``noise_threshold`` is FastSpacedBM's uniform-area
    rejection: a cell whose zero-shift SAD exceeds the minimum by no more
    than the threshold votes (0, 0) (``MinValThreshold``,
    ``src/FastSpacedBMMethod.cl:2``, ``:79-84``)."""
    g, d, _ = sad.shape
    flat = sad.reshape(g, d * d)
    loc = torch.argmin(flat, dim=-1)
    flow = torch.stack([loc % d - scan_radius, loc // d - scan_radius], dim=-1)
    if noise_threshold is not None:
        center = sad[:, scan_radius, scan_radius]
        minval = torch.gather(flat, 1, loc[:, None])[:, 0]
        flat_area = (center - minval) <= noise_threshold
        flow = torch.where(flat_area[:, None], torch.zeros_like(flow), flow)
    return flow


def histogram_vote(
    flow: torch.Tensor, scan_radius: int, *, top_k: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent x / y histogram vote over per-cell flows ``[..., G, 2]``
    (``src/BlockMethod.cpp:59-76``, ``src/FastSpacedBMMethod.cl:120-165``).
    Returns ``(top_x, top_y)``, each ``[..., top_k]``, most-voted first;
    ties go to the smaller shift (lower bin), like the stable bubble sort."""
    d = 2 * scan_radius + 1
    low_first = torch.arange(d, device=flow.device)

    def top(v):
        bins = F.one_hot(v + scan_radius, d).sum(dim=-2)
        return torch.topk(bins * d - low_first, top_k, dim=-1).indices - scan_radius

    return top(flow[..., 0]), top(flow[..., 1])


def _upsample(img: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear ``scale``x upsample with half-pixel centres: equal to
    ``jax.image.resize(img, scale x, "linear")``, whose border samples take
    the edge pixel as ``align_corners=False`` clamping does."""
    h, w = img.shape
    return F.interpolate(img[None, None], size=(scale * h, scale * w), mode="bilinear",
                         align_corners=False)[0, 0]


def refine_subpixel(
    curr: torch.Tensor, prev: torch.Tensor, full_pix_flow: torch.Tensor, passes: int = 2
) -> torch.Tensor:
    """Iterative 2x-upsample +-1 px refinement (``BlockMethod::Refine``,
    ``src/BlockMethod.cpp:96-147``): pass k upsamples both frames 2^k x,
    a 3x3 SAD around the doubled offset picks the best sub-step, and the
    result is the accumulated offset / 2^passes, ``[2]`` float32 (x, y).

    As in the JAX function, the previous frame is upsampled from the
    previous frame (the reference upsamples ``imCurr`` twice, a bug in
    dormant code, ``src/BlockMethod.cpp:109``).  The comparison region of
    a pass is fixed for all 9 probes; inside it no probe wraps around, so
    the JAX ``roll`` is a plain offset here and the offset stays a device
    tensor."""
    curr = curr.to(torch.float32)
    prev = prev.to(torch.float32)
    offset = full_pix_flow.to(torch.int64)  # (x, y), prev-offset sign
    dev = curr.device
    probes = [(m, n) for m in (-1, 0, 1) for n in (-1, 0, 1)]
    steps = torch.tensor([(n, m) for m, n in probes], device=dev)  # (x, y)
    h, w = curr.shape
    scale = 1
    for _ in range(passes):
        scale *= 2
        hh, ww = h * scale, w * scale
        curr_up = _upsample(curr, scale)
        prev_up = _upsample(prev, scale)
        offset = offset * 2
        xs = torch.arange(ww, device=dev)
        ys = torch.arange(hh, device=dev)
        ok_x = (xs >= torch.clamp(-offset[0], min=0) + 1) & (xs < ww - torch.clamp(offset[0], min=0) - 1)
        ok_y = (ys >= torch.clamp(-offset[1], min=0) + 1) & (ys < hh - torch.clamp(offset[1], min=0) - 1)
        mask = ok_y[:, None] & ok_x[None, :]
        sads = []
        for m, n in probes:
            # prev_up[y + oy + m, x + ox + n], clamped: the mask keeps every
            # counted pixel inside the frame
            rows = torch.clamp(ys + offset[1] + m, 0, hh - 1)
            cols = torch.clamp(xs + offset[0] + n, 0, ww - 1)
            shifted = prev_up[rows[:, None], cols[None, :]]
            sads.append(torch.where(mask, torch.abs(curr_up - shifted), 0.0).sum())
        best = torch.argmin(torch.stack(sads))
        offset = offset + steps[best]
    return offset.to(torch.float32) / scale
