"""The reserved message-tag space, in one queryable place (port of
``repro/analyze/tags.py``).

Transport collectives, the in-memory checkpoint store, the topology
collective algorithms and the task pool each own a band of negative tags;
applications must use tags >= 0.  The schedule verifier (app ops matched
against the live reserved set), the lint pass (declared TAG_* constants
checked against the bands) and the observability layer (each message's
traffic class) read this table, so a new subsystem claiming tags updates
exactly one registry.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# (owner, lowest tag, highest tag) — inclusive bands, all negative.
RESERVED_BANDS: Tuple[Tuple[str, int, int], ...] = (
    ("repro_torch.comm.collectives", -18, -11),
    ("repro_torch.store.memstore", -24, -21),
    ("repro_torch.topo.algorithms", -38, -31),
    ("repro_torch.pool.master", -44, -41),
)

# the full reserved envelope apps must stay out of (app tags are
# non-negative; everything negative belongs to the runtime)
RESERVED_MIN = min(lo for _, lo, _ in RESERVED_BANDS)
RESERVED_MAX = max(hi for _, _, hi in RESERVED_BANDS)


def band_owner(tag: int) -> Optional[str]:
    """The subsystem owning ``tag``'s reserved band, or None."""
    for owner, lo, hi in RESERVED_BANDS:
        if lo <= tag <= hi:
            return owner
    return None


def reserved_tags() -> Dict[int, str]:
    """tag value -> "owner.TAG_NAME" for every tag the port registers
    today (imported from the owning modules, so this cannot drift from the
    implementation)."""
    from repro_torch.comm import collectives
    from repro_torch.pool import master
    from repro_torch.store import memstore
    from repro_torch.topo import algorithms

    out: Dict[int, str] = {}
    for mod in (collectives, memstore, algorithms, master):
        for name in dir(mod):
            if name.startswith("TAG_") and isinstance(
                    getattr(mod, name), int):
                out[getattr(mod, name)] = f"{mod.__name__}.{name}"
    return out


def in_infra_module(path: str) -> bool:
    """Whether a source path belongs to a subsystem allowed to declare
    reserved (negative) tags."""
    norm = path.replace("\\", "/")
    return any(part in norm for part in
               ("/comm/", "/store/", "/topo/", "/pool/"))
