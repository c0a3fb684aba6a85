"""CloverLeaf analogue: 2-D compressible Euler on a staggered grid (the port
of ``repro/apps/cloverleaf.py``).

Mirrors the mini-app's structure: cell-centred density/energy/pressure,
node-centred velocities, slab decomposition along y, one halo row exchanged
per neighbour per step, and a global CFL reduction (allreduce min) for the
timestep — the same BSP skeleton as the paper's CloverLeaf runs.

The halo exchange is a ``neighbor_alltoall`` over the slab decomposition's
dist_graph neighbor lists (``topo.graph.line_neighbors``) — the MPI
``MPI_Neighbor_alltoall`` idiom — so it runs through the collective engine
(logging/replay/dedup) instead of raw point-to-point exchanges.

The hydro scheme is a simplified explicit predictor (ideal-gas EOS,
artificial-viscosity-free) — the physics fidelity is irrelevant to the FT
mechanics; determinism and the communication pattern are what matter.

Float64 torch on the app's ``device`` in the reference's order of
operations.  The timestep and the simulated time stay 0-d tensors on the
device (the reference takes ``float(cs.max())``, a host sync a step), and
``0.2 / dt_max`` divides by a tensor: CUDA divides by a host scalar as a
multiply by its reciprocal, which is not the CPU's division.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.topo.graph import line_neighbors

GAMMA = 1.4


class CloverLeaf:
    def __init__(self, n_ranks: int, nx: int = 64, ny_local: int = 16,
                 seed: int = 2, device=None):
        self.n_ranks = n_ranks
        self.nx = nx
        self.ny = ny_local
        self.seed = seed
        self.device = device_lib.resolve(device)
        # dist_graph of the slab decomposition: rank r borders r-1 / r+1
        self.halo_graph = line_neighbors(n_ranks)
        self._cfl = torch.tensor(0.2, dtype=torch.float64,
                                 device=self.device)

    def init_state(self, rank: int) -> dict:
        nx, ny = self.nx, self.ny
        f64 = dict(dtype=torch.float64, device=self.device)
        density = torch.ones((nx, ny), **f64)
        energy = torch.full((nx, ny), 1.0, **f64)
        # a dense hot square in the domain of rank 0 (the clover "charge")
        if rank == 0:
            density[: nx // 4, : ny // 2] = 10.0
            energy[: nx // 4, : ny // 2] = 2.5
        u = torch.zeros((nx, ny), **f64)
        v = torch.zeros((nx, ny), **f64)
        return {"rho": density, "e": energy, "u": u, "v": v,
                "t": torch.zeros((), **f64)}

    @staticmethod
    def _pressure(rho, e):
        return (GAMMA - 1.0) * rho * e

    def step(self, rank, state, step_idx):
        rho, e, u, v = state["rho"], state["e"], state["u"], state["v"]
        p = self._pressure(rho, e)

        # halo exchange: boundary rows of (rho, p, v) with the y-neighbour
        # dist_graph (MPI_Neighbor_alltoall idiom)
        def pack(row):
            return torch.stack([rho[:, row], p[:, row], v[:, row]])

        nbrs = self.halo_graph[rank]
        halos = {}
        if nbrs:
            got = yield ("neighbor_alltoall",
                         [pack(0) if q == rank - 1 else pack(-1)
                          for q in nbrs], nbrs)
            halos = dict(zip(nbrs, got))

        lo = halos.get(rank - 1)
        hi = halos.get(rank + 1)
        p_lo = lo[1] if lo is not None else p[:, 0]
        p_hi = hi[1] if hi is not None else p[:, -1]

        # CFL condition: global min over soundspeed (allreduce, paper-style)
        rho_floor = torch.clamp(rho, min=1e-12)
        cs = torch.sqrt(GAMMA * p / rho_floor)
        local_dt = self._cfl / torch.clamp(cs.max(), min=1e-12)
        dt = yield ("allreduce", local_dt, "min")

        # pressure gradients (central differences; halo rows at y-boundaries)
        px = torch.zeros_like(p)
        px[1:-1, :] = (p[2:, :] - p[:-2, :]) * 0.5
        py = torch.zeros_like(p)
        py[:, 1:-1] = (p[:, 2:] - p[:, :-2]) * 0.5
        py[:, 0] = (p[:, 1] - p_lo) * 0.5
        py[:, -1] = (p_hi - p[:, -2]) * 0.5

        u_new = u - dt * px / rho_floor
        v_new = v - dt * py / rho_floor

        # upwind-ish density/energy advection (tiny velocities -> diffusion)
        u_new = torch.clamp(u_new, -10.0, 10.0)
        v_new = torch.clamp(v_new, -10.0, 10.0)
        div = torch.zeros_like(rho)
        div[1:-1, :] += (u_new[2:, :] - u_new[:-2, :]) * 0.5
        div[:, 1:-1] += (v_new[:, 2:] - v_new[:, :-2]) * 0.5
        # clamped explicit update: keeps arbitrarily long runs finite and
        # bit-deterministic (physics fidelity is not the point here)
        rho_new = torch.clamp(rho - dt * rho * div, 1e-6, 1e3)
        e_new = torch.clamp(e - dt * p * div / rho_floor, 1e-6, 1e3)

        return {"rho": rho_new, "e": e_new, "u": u_new, "v": v_new,
                "t": state["t"] + dt}

    def check(self, states) -> float:
        """Total mass+energy (conserved-ish scalar for run comparison)."""
        return float(sum((s["rho"].sum() + s["e"].sum())
                         for s in states.values()))
