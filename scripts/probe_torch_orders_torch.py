#!/usr/bin/env python3
"""Which order torch sums in on one CUDA card, for the operations of the
plain refit and decomposition that kernel G repeats bit for bit.

    python3 scripts/probe_torch_orders_torch.py [--batches 1,128,512,4096]
        [--rows 18,32,72,128] [--device cuda|cpu]

Kernel G (``csrc/get_rt.cu``) computes getRT in float32 in the plain
version's operation order; where the plain version (``geometry/
homography.py``, ``geometry/motion.py``) sums with a torch reduction or a
cuBLAS product, the order is not written in the code.  For each such
operation at the plain version's shapes this script runs torch on seeded
random float32 inputs, emulates candidate orders in float64 with one
float32 rounding after every addition, product or fused multiply-add, and
prints one JSON line an operation with the candidates' shares of outputs
equal to torch's, best first:

- ``einsum`` ``"...m,...mk->...k"`` over ``M`` rows (the refit's
  ``v^T A``) at each batch (``1``: one pair's unbatched product): one fused
  chain, the rows in n interleaved or contiguous parts each a chain, the
  parts added in order or as a tree;
- ``solve_triangular``, lower (``R^T``) and upper, 9 x 9: fused updates
  forward or backward, a division or a multiplication by the reciprocal;
- ``[3, 3] @ [3, 1]``, ``[3, 3] @ [3, 3]`` and ``A^T @ A``: every order and
  fusion of the three terms;
- ``torch.linalg.norm`` and ``sum`` over the last dimension at n = 3, 4, 9,
  32, 128 and one pair's norm over M rows: torch's reduction kernel
  (``ATen/native/cuda/Reduce.cuh``: the largest power of two <= n lanes,
  up to 4 accumulators a lane, from 128 values 4 neighbours a load, a tree
  with decreasing offsets) against a left-to-right sum; and the norm of a
  strided ``[B, 9]`` view (the batched refit's seed), one thread an output.

Each line carries the card's ``nvidia-smi`` name and power limit.  With
``--device cpu`` it reports the CPU's orders, which G does not follow.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="1,128,512,4096")
    ap.add_argument("--rows", default="18,32,72,128")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def rnd(x):
    """float64 values rounded to float32 (and back)."""
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def fma(a, b, c):
    """float32 fused multiply-add: the float32 product is exact in float64."""
    return rnd(a * b + c)


def chain(v, a, rows):
    acc = np.zeros(a.shape[:1] + a.shape[2:])
    for m in rows:
        acc = fma(v[:, m, None], a[:, m], acc)
    return acc


def combine(parts, how: str):
    if how == "seq":
        acc = parts[0]
        for p in parts[1:]:
            acc = rnd(acc + p)
        return acc
    while len(parts) > 1:
        nxt = [rnd(parts[i] + parts[i + 1]) for i in range(0, len(parts) - 1, 2)]
        parts = nxt + ([parts[-1]] if len(parts) % 2 else [])
    return parts[0]


def einsum_candidates(v, a):
    m = v.shape[1]
    cand = {"chain": chain(v, a, range(m))}
    for n in range(2, 9):
        size = -(-m // n)
        bounds = [min(m, i * size) for i in range(n)] + [m]
        contiguous = [chain(v, a, range(bounds[i], bounds[i + 1])) for i in range(n)]
        interleaved = [chain(v, a, range(p, m, n)) for p in range(n)]
        for how in ("seq", "tree"):
            cand[f"parts{n}_{how}"] = combine(contiguous, how)
            cand[f"interleaved{n}_{how}"] = combine(interleaved, how)
    return cand


def three(a0, b0, a1, b1, a2, b2) -> dict:
    """Every order and fusion of a0 b0 + a1 b1 + a2 b2 (``f`` marks the
    second and third additions fused or not)."""
    terms = ((a0, b0), (a1, b1), (a2, b2))
    out = {}
    for perm in itertools.permutations(range(3)):
        (pa, pb), (qa, qb), (sa, sb) = (terms[i] for i in perm)
        for f2, f3 in itertools.product((0, 1), repeat=2):
            acc = rnd(pa * pb)
            acc = fma(qa, qb, acc) if f2 else rnd(acc + rnd(qa * qb))
            acc = fma(sa, sb, acc) if f3 else rnd(acc + rnd(sa * sb))
            out[f"{''.join(map(str, perm))}_f{f2}{f3}"] = acc
    return out


def solve(r, b, lower: bool, order: str, div: str):
    x = np.zeros_like(b)
    for i in (range(9) if lower else range(8, -1, -1)):
        ks = list(range(i)) if lower else list(range(i + 1, 9))
        if order == "backward":
            ks = ks[::-1]
        acc = b[:, i].copy()
        for k in ks:
            acc = fma(-(r[:, k, i] if lower else r[:, i, k]), x[:, k], acc)
        x[:, i] = rnd(acc / r[:, i, i]) if div == "div" else rnd(acc * rnd(1.0 / r[:, i, i]))
    return x


def torch_reduce(x, square: bool):
    """torch's CUDA reduction over the last dimension of ``x`` ``[n_out, n]``
    (rows 16-byte aligned): from n = 128 on, each lane loads 4 neighbours
    at a time into its 4 accumulators; below, lane t takes values t, t +
    bw, ... (4 accumulators, in turn)."""
    n = x.shape[1]
    vec4 = n >= 128
    bw = 1
    while bw * 2 <= min(n // 4 if vec4 else n, 32):
        bw *= 2
    lanes = []
    for t in range(bw):
        vl = [np.zeros(x.shape[0]) for _ in range(4)]

        def add(i, xi):
            vl[i] = rnd(xi * xi + vl[i]) if square else rnd(vl[i] + xi)

        if vec4:
            idx = t
            while idx * 4 + 3 < n:
                for i in range(4):
                    add(i, x[:, idx * 4 + i])
                idx += bw
            if n - n % 4 + t < n:
                add(0, x[:, n - n % 4 + t])
        else:
            idx = t
            while idx + 3 * bw < n:
                for i in range(4):
                    add(i, x[:, idx + i * bw])
                idx += 4 * bw
            for i in range(4):
                if idx < n:
                    add(i, x[:, idx])
                    idx += bw
        acc = vl[0]
        for i in range(1, 4):
            acc = rnd(acc + vl[i])
        lanes.append(acc)
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [rnd(lanes[i] + lanes[i + h]) for i in range(h)]
    return rnd(np.sqrt(lanes[0])) if square else lanes[0]


def run(args, emit) -> None:
    import torch

    from mrs_optic_flow_tpu_torch.utils import benchlib
    from mrs_optic_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    card = benchlib.card_name() if dev.type == "cuda" else "cpu"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def report(op: str, got, cand: dict, **shape):
        got = f64(got)
        shares = {k: float((got.reshape(v.shape) == v).mean()) for k, v in cand.items()}
        best = sorted(shares.items(), key=lambda kv: -kv[1])[:4]
        emit({"op": op, **shape, "best": best, "card": card})

    for b in (int(v) for v in args.batches.split(",")):
        one = b == 1
        for m in (int(v) for v in args.rows.split(",")):
            v, a = randn(max(b, 1), m), randn(max(b, 1), m, 9)
            got = torch.einsum("...m,...mk->...k", v[0] if one else v, a[0] if one else a)
            report("einsum", got, einsum_candidates(f64(v), f64(a)), batch=b, rows=m)
        r = torch.triu(randn(b, 9, 9)) + 2.5 * torch.eye(9, device=dev)
        rhs = randn(b, 9)
        rt, bt = (r[0], rhs[0]) if one else (r, rhs)
        for lower in (True, False):
            mat = rt.transpose(-1, -2) if lower else rt
            got = torch.linalg.solve_triangular(mat, bt[..., None], upper=not lower)[..., 0]
            cand = {f"{o}_{d}": solve(f64(r), f64(rhs), lower, o, d)
                    for o in ("forward", "backward") for d in ("div", "rcp")}
            report("solve_triangular", got, cand, batch=b, lower=lower)
        a, t = randn(b, 3, 3), randn(b, 3)
        an, tn = f64(a), f64(t)
        cands = [three(an[:, i, 0], tn[:, 0], an[:, i, 1], tn[:, 1], an[:, i, 2], tn[:, 2]) for i in range(3)]
        report("bmm_33_31", (a @ t[..., :, None])[..., 0], {k: np.stack([c[k] for c in cands], -1) for k in cands[0]},
               batch=b)
        for name, got, transposed in (("bmm_33_33", a @ a, False),
                                      ("bmm_33t_33", a.transpose(-1, -2) @ a, True)):
            cand: dict = {}
            for i in range(3):
                for j in range(3):
                    lhs = [an[:, k, i] if transposed else an[:, i, k] for k in range(3)]
                    c = three(lhs[0], an[:, 0, j], lhs[1], an[:, 1, j], lhs[2], an[:, 2, j])
                    for k, val in c.items():
                        cand.setdefault(k, np.zeros((b, 3, 3)))[:, i, j] = val
            report(name, got, cand, batch=b)
    for n in (3, 4, 9, 32, 128):
        x = randn(4096, n)
        xn = f64(x)
        left = np.zeros(4096)
        sq = np.zeros(4096)
        for i in range(n):
            left = rnd(left + xn[:, i])
            sq = rnd(sq + rnd(xn[:, i] ** 2))
        report("norm", torch.linalg.norm(x, dim=-1), {"reduce_kernel": torch_reduce(xn, True),
                                                      "left_to_right": rnd(np.sqrt(sq))}, n=n)
        report("sum", x.sum(-1), {"reduce_kernel": torch_reduce(xn, False), "left_to_right": left}, n=n)
    for m in (int(v) for v in args.rows.split(",")):
        x = randn(m)
        report("norm_one_output", torch.linalg.norm(x, dim=-1, keepdim=True),
               {"reduce_kernel": torch_reduce(f64(x)[None], True)}, n=m)
    # the batched seed: a [B, 9] view of a [9, B] tensor, each output summed
    # by one thread in 4 accumulators in turn
    x = randn(9, 4096).T
    xn = f64(x)
    vl = [rnd(xn[:, i] ** 2) for i in range(4)]
    vl = [fma(xn[:, 4 + i], xn[:, 4 + i], vl[i]) for i in range(4)]
    vl[0] = fma(xn[:, 8], xn[:, 8], vl[0])
    report("norm_strided", torch.linalg.norm(x, dim=-1, keepdim=True),
           {"one_thread_4_accumulators": rnd(np.sqrt(rnd(rnd(rnd(vl[0] + vl[1]) + vl[2]) + vl[3]))),
            "reduce_kernel": torch_reduce(xn, True)}, n=9)


def main(argv=None) -> int:
    run(parse_args(argv), lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
