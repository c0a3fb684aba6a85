"""PIC analogue of Decyk's skeleton codes: 1-D decomposed electrostatic
particle-in-cell (the port of ``repro/apps/pic.py``).

Per step (the classic PIC loop the paper ran):
  1. deposit  - scatter particle charge onto the local grid,
  2. guard-cell exchange - halo sums with both neighbours (point-to-point),
  3. field solve - global FFT-free Poisson solve via parallel cumulative
     sums (allreduce) on the 1-D mean field,
  4. push     - gather E at particle positions, advance velocities/positions,
  5. migrate  - particles crossing slab boundaries are shipped to their new
     owner with one ``alltoall`` of per-destination particle blocks
     (variable-size payloads — the interesting case for sender-based
     message logging and replay; the collective decomposes into logged
     point-to-point sends in ``comm.collectives``, MPI_Alltoallv-style).

Float64 torch on the app's ``device``, deterministic on the card:
  * the deposit is ``index_put_(accumulate=True)``: on the CPU a serial
    loop in particle order (bitwise ``np.add.at``), on CUDA a stable sort
    of the cells and a fixed-order sum of each cell's run — no atomics;
  * the migration sorts the particles by owner (a stable sort, so each
    block keeps the order a boolean mask would give) and splits them with
    one host sync for the block sizes (``searchsorted`` on the sorted
    owners; ``bincount`` would count with atomics);
  * the field's cumulative sum is ``inclusive_scan``, two levels of
    triangular matrix products: ``torch.cumsum`` of floats has no
    deterministic CUDA implementation (it raises under
    ``torch.use_deterministic_algorithms``);
  * ``np.mod(pos, L)`` is ``fmod`` with numpy's sign fix (a result of zero
    is +0.0), and every division by a constant divides by a 0-d tensor:
    CUDA divides by a host scalar as a multiply by its reciprocal, which
    could move a particle across a cell or slab boundary against the CPU;
  * the canonical order (``np.lexsort((vel, pos))``) is two stable sorts.
The sums (``rho_local.sum()``, the prefix and total of the allreduce, the
scan) take other orders than numpy's, so values differ from the
reference's in the last bits; the initial particles are drawn with numpy
as the reference draws them, bitwise the same.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as device_lib

TAG_GUARD = 3


def np_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.mod(a, b)`` for a positive 0-d ``b``: ``fmod`` plus ``b`` where
    the remainder is negative, and +0.0 where it is zero (numpy's
    ``copysign(0, b)``)."""
    mod = torch.fmod(a, b)
    mod = torch.where(mod < 0, mod + b, mod)
    return torch.where(mod == 0, 0.0, mod)


def inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """``cumsum`` of a 1-D float tensor, deterministic on every device: x
    in rows of b >= sqrt(len) entries, each row's prefix sums as a product
    with an upper-triangular matrix of ones, and each row offset by the
    sum of the rows before it (a product with a strictly lower-triangular
    one)."""
    n = x.numel()
    b = math.isqrt(max(n - 1, 0)) + 1               # b * b >= n
    rows = -(-n // b)
    ones = dict(dtype=x.dtype, device=x.device)
    blocks = torch.cat([x, x.new_zeros(rows * b - n)]).reshape(rows, b)
    within = blocks @ torch.ones(b, b, **ones).triu()
    offsets = torch.ones(rows, rows, **ones).tril(-1) @ within[:, -1]
    return (within + offsets[:, None]).reshape(-1)[:n]


def migrate_blocks(pos: torch.Tensor, vel: torch.Tensor,
                   owner: torch.Tensor, n: int):
    """One ``stack([pos[owner == d], vel[owner == d]])`` block per
    destination d, in particle order within each block: a stable sort by
    owner and one split (one host sync for the sizes) instead of two
    boolean masks per destination."""
    sorted_owner, order = torch.sort(owner, stable=True)
    edges = torch.searchsorted(
        sorted_owner, torch.arange(n + 1, device=owner.device))
    sizes = (edges[1:] - edges[:-1]).tolist()
    both = torch.stack([pos, vel])[:, order]
    return list(torch.split(both, sizes, dim=1))


class PIC:
    def __init__(self, n_ranks: int, cells_per_rank: int = 64,
                 particles_per_rank: int = 512, seed: int = 3, device=None):
        self.n_ranks = n_ranks
        self.nc = cells_per_rank
        self.np_ = particles_per_rank
        self.seed = seed
        self.L = n_ranks * cells_per_rank      # global domain length
        self.device = device_lib.resolve(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self._nc = torch.tensor(float(self.nc), **f64)
        self._L = torch.tensor(float(self.L), **f64)

    def init_state(self, rank: int) -> dict:
        rng = np.random.default_rng(self.seed + 17 * rank)
        lo = rank * self.nc
        pos = lo + rng.random(self.np_) * self.nc
        vel = rng.standard_normal(self.np_) * 0.5
        return {"pos": torch.from_numpy(pos).to(self.device),
                "vel": torch.from_numpy(vel).to(self.device), "t": 0.0}

    def step(self, rank, state, step_idx):
        n = self.n_ranks
        nc, L = self.nc, self.L
        lo = rank * nc
        pos, vel = state["pos"], state["vel"]
        f64 = dict(dtype=torch.float64, device=pos.device)

        # 1. deposit (linear weighting onto local grid + one guard cell/side)
        rho = torch.zeros(nc + 2, **f64)       # [guard_lo, cells..., guard_hi]
        x = pos - lo                             # local coords in [0, nc)
        cell = torch.floor(x).to(torch.int64)
        frac = x - cell
        rho.index_put_((cell + 1,), 1.0 - frac, accumulate=True)
        rho.index_put_((cell + 2,), frac, accumulate=True)

        # 2. guard-cell exchange (sum halo contributions with neighbours;
        # the transport captures the sent views by a clone)
        left = (rank - 1) % n
        right = (rank + 1) % n
        out = {}
        if n > 1:
            send_l = rho[0:1]
            send_r = rho[nc + 1:nc + 2]
            if left == right:                    # n == 2: one neighbour
                out[left] = torch.cat([send_l, send_r])
                got = yield ("exchange", out, TAG_GUARD)
                rho[nc] += got[left][0]
                rho[1] += got[left][1]
            else:
                out[left] = send_l
                out[right] = send_r
                got = yield ("exchange", out, TAG_GUARD)
                rho[1] += got[left][0]
                rho[nc] += got[right][0]
        rho_local = rho[1:nc + 1] - (len(pos) / nc)  # neutralizing background

        # 3. 1-D Poisson: E(x) = cumulative charge - global mean line charge
        local_q = rho_local.sum()
        # exclusive prefix over ranks via allreduce of masked contributions
        mine = torch.zeros(n, **f64)
        mine[rank] = local_q
        allq = yield ("allreduce", mine, "sum")
        prefix = allq[:rank].sum()
        e_field = prefix + inclusive_scan(rho_local) - rho_local * 0.5
        total = allq.sum()
        centres = torch.arange(lo, lo + nc, **f64) + 0.5
        e_field = e_field - total * centres / self._L

        # 4. push (leapfrog, gather E at particle positions)
        eg = e_field[torch.clamp(cell, max=nc - 1)]
        vel = vel - 0.05 * eg
        pos = pos + 0.1 * vel
        pos = np_mod(pos, self._L)                 # periodic domain

        # 5. migrate: one alltoall of per-destination particle blocks (the
        # classic MPI_Alltoallv migration idiom) — any rank can receive
        # from any other, so no long-range-stray guard is needed
        owner = torch.floor(pos / self._nc).to(torch.int64) % n
        if n > 1:
            got = yield ("alltoall", migrate_blocks(pos, vel, owner, n))
            pos = torch.cat([b[0] for b in got])
            vel = torch.cat([b[1] for b in got])
        # canonical order: sort by position then velocity so the state is
        # permutation-independent (bitwise-reproducible across failover)
        by_vel = torch.argsort(vel, stable=True)
        order = by_vel[torch.argsort(pos[by_vel], stable=True)]
        return {"pos": pos[order], "vel": vel[order],
                "t": state["t"] + 0.1}

    def check(self, states) -> float:
        """Total momentum + particle count (conservation scalar)."""
        mom = sum(float(s["vel"].sum()) for s in states.values())
        cnt = sum(len(s["pos"]) for s in states.values())
        return mom + cnt
