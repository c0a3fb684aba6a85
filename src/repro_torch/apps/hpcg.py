"""HPCG analogue: conjugate gradient on a 3-D 7-point Laplacian (the port of
``repro/apps/hpcg.py``).

Weak-scaling layout identical to HPCG's: each rank owns an (nx, ny, nz)
sub-grid stacked along z; SpMV needs one halo plane from each z-neighbour
(point-to-point exchange) and CG needs two dot products per iteration
(allreduce) — the same communication skeleton the paper's HPCG runs
exercised. One app step = one CG iteration.

All arithmetic is float64 torch on the app's ``device`` with the
reference's operation order, so runs are bit-reproducible on one device —
the FT theorem test compares exactly.  The scalars of CG (``rr``, ``pq``,
``alpha``, ``beta``) stay 0-d tensors on the device: no step waits on the
host.  ``torch.dot`` and ``np.dot`` sum in different orders, so the port's
values differ from the reference's in the last bits; the initial state is
drawn with numpy as the reference draws it, so it is bitwise the same.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib

TAG_HALO = 1


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


class HPCG:
    def __init__(self, n_ranks: int, nx: int = 16, ny: int = 16,
                 nz: int = 8, seed: int = 1, device=None):
        self.n_ranks = n_ranks
        self.nx, self.ny, self.nz = nx, ny, nz
        self.seed = seed
        self.device = device_lib.resolve(device)

    def init_state(self, rank: int) -> dict:
        rng = np.random.default_rng(self.seed + rank)
        shape = (self.nx, self.ny, self.nz)
        b = torch.from_numpy(rng.standard_normal(shape)).to(self.device)
        x = torch.zeros(shape, dtype=torch.float64, device=self.device)
        return {"b": b, "x": x, "r": b.clone(), "p": b.clone(),
                "rr": None, "iters": 0}

    # -- operator ------------------------------------------------------------

    def _spmv(self, rank, p, lo_halo, hi_halo):
        """7-point Laplacian with Dirichlet walls in x, y and rank-boundary
        halos in z."""
        q = 6.0 * p
        q[1:, :, :] -= p[:-1, :, :]
        q[:-1, :, :] -= p[1:, :, :]
        q[:, 1:, :] -= p[:, :-1, :]
        q[:, :-1, :] -= p[:, 1:, :]
        q[:, :, 1:] -= p[:, :, :-1]
        q[:, :, :-1] -= p[:, :, 1:]
        if lo_halo is not None:
            q[:, :, 0] -= lo_halo
        if hi_halo is not None:
            q[:, :, -1] -= hi_halo
        return q

    def step(self, rank, state, step_idx):
        n = self.n_ranks
        p = state["p"]
        # halo exchange of boundary z-planes with neighbours (the transport
        # captures each plane by a clone at the send)
        out = {}
        if rank > 0:
            out[rank - 1] = p[:, :, 0]
        if rank < n - 1:
            out[rank + 1] = p[:, :, -1]
        halos = {}
        if out:
            halos = yield ("exchange", out, TAG_HALO)
        lo = halos.get(rank - 1) if rank > 0 else None
        hi = halos.get(rank + 1) if rank < n - 1 else None

        q = self._spmv(rank, p, lo, hi)
        rr = state["rr"]
        if rr is None:
            rr = yield ("allreduce", _dot(state["r"], state["r"]), "sum")
        pq = yield ("allreduce", _dot(p, q), "sum")
        # ``rr / pq if pq != 0 else 0.0`` without a host sync
        alpha = torch.where(pq != 0, rr / pq, 0.0)
        x = state["x"] + alpha * p
        r = state["r"] - alpha * q
        rr_new = yield ("allreduce", _dot(r, r), "sum")
        beta = torch.where(rr != 0, rr_new / rr, 0.0)
        p_new = r + beta * p
        return {"b": state["b"], "x": x, "r": r, "p": p_new,
                "rr": rr_new, "iters": state["iters"] + 1}

    def check(self, states) -> float:
        """Global residual norm (the verification scalar)."""
        return float(torch.sqrt(sum(_dot(s["r"], s["r"])
                                    for s in states.values())))
