"""Homography estimation and decomposition (port of
:mod:`mrs_optic_flow_tpu.geometry.homography`).

- ``cv::findHomography(..., cv::RANSAC, 0.01)`` (``src/optic_flow.cpp:558``)
  -> :func:`find_homography_ransac`: a fixed budget of closed-form 4-point
  hypotheses scored together, then a least-squares DLT refit on the
  consensus set.
- ``cv::decomposeHomographyMat`` (``src/optic_flow.cpp:592``) ->
  :func:`decompose_homography`, the Malis-Vargas analytical decomposition.

Points are normalized camera coordinates.  Everything stays in float32 on
the device of the inputs, with no host synchronisation; the matrix products
run at full float32 whatever the process's TF32 setting (``pinned``, the
JAX package's ``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mrs_optic_flow_tpu_torch.utils.precision import pinned


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-dim device index, without a host round trip."""
    return x.index_select(0, idx.reshape(1))[0]


def _dlt_rows(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT design matrix ``[..., 2N, 9]`` for H mapping src -> dst
    (points ``[..., N, 2]``); ``w`` ``[..., N]`` row weights (0 masks a point
    out)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v], dim=-1)
    a = torch.cat([r1, r2], dim=-2)
    return a * torch.cat([w, w], dim=-1)[..., None]


def _norm_h(h: torch.Tensor) -> torch.Tensor:
    """Normalize so h22 ~ 1 where possible (OpenCV convention)."""
    h22 = h[..., 2, 2]
    scale = torch.where(h22.abs() > 1e-12, h22, torch.ones_like(h22))
    return h / scale[..., None, None]


@pinned
def _solve_h4(src4: torch.Tensor, dst4: torch.Tensor) -> torch.Tensor:
    """Exact homography from 4 point pairs ``[..., 4, 2]`` -> ``[..., 3, 3]``
    by the division-free projective canonical-basis method:
    ``H = H_dst . adj(H_src)``.  Degenerate draws give a rank-deficient H
    that loses the consensus vote."""

    def _side(p):
        a1, a2, a3, a4 = (p[..., i, 0] for i in range(4))
        b1, b2, b3, b4 = (p[..., i, 1] for i in range(4))

        def det(pa, pb, qa, qb, ra, rb):
            return pa * (qb - rb) + qa * (rb - pb) + ra * (pb - qb)

        d1 = det(a4, b4, a2, b2, a3, b3)
        d2 = det(a1, b1, a4, b4, a3, b3)
        d3 = det(a1, b1, a2, b2, a4, b4)
        r0 = torch.stack([d1 * a1, d2 * a2, d3 * a3], dim=-1)
        r1 = torch.stack([d1 * b1, d2 * b2, d3 * b3], dim=-1)
        r2 = torch.stack([d1, d2, d3], dim=-1)
        return torch.stack([r0, r1, r2], dim=-2)

    hs = _side(src4)
    hd = _side(dst4)
    cols = []
    for i in range(3):
        rows = []
        for j in range(3):
            r1, r2 = (r for r in range(3) if r != j)  # adj[i][j] = cof[j][i]
            c1, c2 = (c for c in range(3) if c != i)
            minor = hs[..., r1, c1] * hs[..., r2, c2] - hs[..., r1, c2] * hs[..., r2, c1]
            rows.append(minor if (i + j) % 2 == 0 else -minor)
        cols.append(torch.stack(rows, dim=-1))
    adj = torch.stack(cols, dim=-2)
    return _norm_h(hd @ adj)


@pinned
def _solve_h_qr_null(a: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Smallest right-singular vector of ``A`` ``[..., M, 9]`` by Householder
    QR, then 3 rounds of inverse iteration ``x <- R^-1 R^-T x`` seeded with
    ``h0``.  Diagonal entries of ``R`` below 1e-12 in magnitude are replaced
    by 1e-12 (the JAX package's guarded solves)."""
    k = a.shape[-1]
    rows = torch.arange(a.shape[-2], device=a.device)
    r = a
    for j in range(k):
        col = r[..., :, j]
        x = torch.where(rows >= j, col, torch.zeros_like(col))
        normx = torch.linalg.norm(x, dim=-1, keepdim=True)
        rjj = col[..., j : j + 1]
        sign = torch.where(rjj >= 0.0, 1.0, -1.0).to(a.dtype)
        u1 = rjj + sign * normx
        safe = normx > 1e-30
        v = torch.where(safe, x / torch.where(u1.abs() > 1e-30, u1, torch.ones_like(u1)), torch.zeros_like(x))
        v = torch.where(rows == j, safe.to(a.dtype), v)  # v[j] = 1 (0 for a zero column)
        tau = torch.where(
            safe, sign * u1 / torch.where(normx > 1e-30, normx, torch.ones_like(normx)),
            torch.zeros_like(normx),
        )
        w = torch.einsum("...m,...mk->...k", v, r)
        r = r - tau[..., :, None] * v[..., :, None] * w[..., None, :]
    r = r[..., :k, :]  # [..., 9, 9] upper triangular

    diag = torch.diagonal(r, dim1=-2, dim2=-1)
    dsafe = torch.where(diag.abs() > 1e-12, diag, torch.full_like(diag, 1e-12))
    r = r - torch.diag_embed(diag) + torch.diag_embed(dsafe)

    x = h0.reshape(h0.shape[:-2] + (k,))
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)
    for _ in range(3):
        z = torch.linalg.solve_triangular(r.transpose(-1, -2), x[..., None], upper=False)
        x = torch.linalg.solve_triangular(r, z, upper=True)[..., 0]
        x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)
    return _norm_h(x.reshape(a.shape[:-2] + (3, 3)))


def _project(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply homography h ``[..., 3, 3]`` to pts ``[N, 2]`` -> ``[..., N, 2]``."""
    x = pts[..., 0]
    y = pts[..., 1]
    d = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    d = torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
    u = (h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]) / d
    v = (h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]) / d
    return torch.stack([u, v], dim=-1)


def draw_hypotheses(
    valid: torch.Tensor, iterations: int, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """``[iterations, 4]`` indices of distinct valid points, each row drawn
    with probability proportional to ``valid`` and without replacement by
    Gumbel top-k — the distribution of the JAX package's
    ``jax.random.choice(p=valid, replace=False)`` (``homography.py:236``)."""
    p = valid.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    u = torch.rand(
        (iterations, valid.shape[0]), generator=generator, device=valid.device, dtype=p.dtype
    )
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(p.dtype).tiny)))
    return torch.topk(torch.log(p)[None, :] + gumbel, 4, dim=-1).indices


class HomographyResult(NamedTuple):
    h: torch.Tensor  # [3, 3]
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # 0-dim int64
    ok: torch.Tensor  # 0-dim bool


def find_homography_ransac(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    hyp_idx: Optional[torch.Tensor] = None,
    threshold: float = 0.01,
    iterations: int = 512,
) -> HomographyResult:
    """RANSAC homography over masked points.

    ``src``/``dst``: ``[N, 2]`` normalized coords; ``valid``: ``[N]`` bool.
    ``threshold`` is the forward reprojection distance (0.01,
    ``src/optic_flow.cpp:558``).  ``hyp_idx`` ``[iterations, 4]`` gives the
    hypotheses' point indices; without it they are drawn from ``generator``
    by :func:`draw_hypotheses`.
    """
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    src = torch.where(valid[:, None], src, zero)
    dst = torch.where(valid[:, None], dst, zero)
    if hyp_idx is None:
        hyp_idx = draw_hypotheses(valid, iterations, generator)
    hs = _solve_h4(src[hyp_idx], dst[hyp_idx])  # [iters, 3, 3]
    errs = torch.sum((_project(hs[:, None], src[None]) - dst[None]) ** 2, dim=-1)
    inls = (errs < threshold * threshold) & valid[None, :]
    counts = inls.sum(dim=-1)
    best = torch.argmax(counts)
    inliers = _take(inls, best)
    n_inl = _take(counts, best)
    h = _solve_h_qr_null(_dlt_rows(src, dst, inliers.to(src.dtype)), _take(hs, best))
    ok = n_inl >= 4
    h = torch.where(ok, h, torch.eye(3, dtype=src.dtype, device=src.device))
    return HomographyResult(h=h, inliers=inliers, n_inliers=n_inl, ok=ok)


class HomographyDecomposition(NamedTuple):
    rotations: torch.Tensor  # [4, 3, 3]
    translations: torch.Tensor  # [4, 3]
    normals: torch.Tensor  # [4, 3]
    n_solutions: torch.Tensor  # 0-dim int (1 or 4)


def _opposite_of_minor(m: torch.Tensor, row: int, col: int) -> torch.Tensor:
    x1 = 1 if col == 0 else 0
    x2 = 1 if col == 2 else 2
    y1 = 1 if row == 0 else 0
    y2 = 1 if row == 2 else 2
    return m[..., y1, x2] * m[..., y2, x1] - m[..., y1, x1] * m[..., y2, x2]


def _signd(x: torch.Tensor) -> torch.Tensor:
    """sign with signd(0) = +1 (OpenCV homography_decomp convention)."""
    return torch.where(x >= 0.0, 1.0, -1.0).to(x.dtype)


def _det3x3(m: torch.Tensor) -> torch.Tensor:
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


@pinned
def _sv_middle_3x3(h: torch.Tensor) -> torch.Tensor:
    """Middle singular value of a 3x3 from the closed-form (trigonometric)
    eigenvalues of ``H^T H``."""
    a = h.transpose(-1, -2) @ h
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(b * b, dim=(-2, -1)) / 6.0, min=0.0))
    psafe = torch.where(p > 1e-30, p, torch.ones_like(p))
    rr = torch.clamp(_det3x3(b / psafe[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(rr) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = torch.where(p > 1e-30, 3.0 * q - e1 - e3, q)
    return torch.sqrt(torch.clamp(e2, min=0.0))


@pinned
def decompose_homography(h: torch.Tensor) -> HomographyDecomposition:
    """Analytical Malis-Vargas decomposition of a calibrated homography: the
    solution set of ``cv::decomposeHomographyMat(H, I)``, up to four
    ``{R, t, n}`` with ``H ~ gamma * (R + t n^T)``, ordered
    ``[Ra+, Ra-, Rb+, Rb-]``.  For a (near-)pure rotation solution 0 is
    ``{H_n, 0, 0}`` and ``n_solutions == 1``.  ``v`` is clamped away from 0
    (``|v| <= 1e-30`` -> 1e-30) before it divides, as in the JAX package's
    batched decomposition (``geometry/batched.py:373``); ``v = 2 s1 s3`` of
    ``H_n``'s singular values, so only a singular H reaches the clamp."""
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    gamma = _sv_middle_3x3(h)
    hn = h / gamma[..., None, None]
    hn = hn * _signd(_det3x3(hn))[..., None, None]

    s = hn.transpose(-1, -2) @ hn - eye
    rotation_only = torch.amax(s.abs(), dim=(-2, -1)) < 1e-3

    m00 = _opposite_of_minor(s, 0, 0)
    m11 = _opposite_of_minor(s, 1, 1)
    m22 = _opposite_of_minor(s, 2, 2)
    rt_m00 = torch.sqrt(torch.clamp(m00, min=0.0))
    rt_m11 = torch.sqrt(torch.clamp(m11, min=0.0))
    rt_m22 = torch.sqrt(torch.clamp(m22, min=0.0))
    e12 = _signd(_opposite_of_minor(s, 1, 2))
    e02 = _signd(_opposite_of_minor(s, 0, 2))
    e01 = _signd(_opposite_of_minor(s, 0, 1))

    s00, s11, s22 = s[..., 0, 0], s[..., 1, 1], s[..., 2, 2]
    s01, s02, s12 = s[..., 0, 1], s[..., 0, 2], s[..., 1, 2]
    idx = torch.argmax(torch.stack([s00.abs(), s11.abs(), s22.abs()], -1), dim=-1)
    is0 = (idx == 0)[..., None]
    is1 = (idx == 1)[..., None]

    npa0 = torch.stack([s00, s01 + rt_m22, s02 + e12 * rt_m11], -1)
    npb0 = torch.stack([s00, s01 - rt_m22, s02 - e12 * rt_m11], -1)
    npa1 = torch.stack([s01 + rt_m22, s11, s12 - e02 * rt_m00], -1)
    npb1 = torch.stack([s01 - rt_m22, s11, s12 + e02 * rt_m00], -1)
    npa2 = torch.stack([s02 + e01 * rt_m11, s12 + rt_m00, s22], -1)
    npb2 = torch.stack([s02 - e01 * rt_m11, s12 - rt_m00, s22], -1)
    npa = torch.where(is0, npa0, torch.where(is1, npa1, npa2))
    npb = torch.where(is0, npb0, torch.where(is1, npb1, npb2))

    trace_s = s00 + s11 + s22
    v = 2.0 * torch.sqrt(torch.clamp(1.0 + trace_s - m00 - m11 - m22, min=0.0))
    s_ii = torch.where(idx == 0, s00, torch.where(idx == 1, s11, s22))
    es_ii = _signd(s_ii)
    r = torch.sqrt(torch.clamp(2.0 + trace_s + v, min=0.0))
    nt = torch.sqrt(torch.clamp(2.0 + trace_s - v, min=0.0))

    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)

    na = unit(npa)
    nb = unit(npb)
    half_nt = 0.5 * nt
    esii_t_r = es_ii * r
    ta_star = half_nt[..., None] * (esii_t_r[..., None] * nb - nt[..., None] * na)
    tb_star = half_nt[..., None] * (esii_t_r[..., None] * na - nt[..., None] * nb)

    inv_v = 2.0 / torch.where(v.abs() > 1e-30, v, 1e-30)

    def rmat_from(tstar, nvec):
        # R = Hn (I - (2/v) tstar n^T)
        outer = tstar[..., :, None] * nvec[..., None, :]
        return hn @ (eye - inv_v[..., None, None] * outer)

    ra = rmat_from(ta_star, na)
    rb = rmat_from(tb_star, nb)
    ta = (ra @ ta_star[..., :, None])[..., 0]
    tb = (rb @ tb_star[..., :, None])[..., 0]

    rots = torch.stack([ra, ra, rb, rb], dim=-3)
    trans = torch.stack([ta, -ta, tb, -tb], dim=-2)
    norms = torch.stack([na, -na, nb, -nb], dim=-2)

    # pure-rotation case in slot 0
    ro_m = rotation_only[..., None, None, None]
    ro_v = rotation_only[..., None, None]
    rots = torch.where(ro_m, hn[..., None, :, :].expand(rots.shape), rots)
    trans = torch.where(ro_v, torch.zeros_like(trans), trans)
    norms = torch.where(ro_v, torch.zeros_like(norms), norms)
    n_solutions = torch.where(rotation_only, 1, 4)
    return HomographyDecomposition(rots, trans, norms, n_solutions)
