"""Per-link utilization measured from the topo cost model's pricing (a
copy of ``repro/obs/links.py``).

``topo.TopoCostModel`` prices every transport message with
α·hops + bytes/β; this accumulator rides the same per-message path and
deposits each message's bytes on every link of its route — exactly the
contention accounting ``round_time`` applies analytically — so a run
produces a *measured* heat table (bytes, busy seconds, message count
per link) instead of only fig15's closed-form ratios.

Busy time per link is ``bytes / (β · link_share(link))``: the drain
time of the deposited load at the bandwidth the link actually offers
(fat-tree up-links divide by the oversubscription factor).  The
max-contended link is the one with the largest busy time; per-label
tables (label = collective tag name, tag band, or "switchboard" for
phantom-priced in-memory matches) attribute the contention to the
traffic class that caused it.

Attached to a transport as ``transport.link_usage`` by the
ObsRecorder; ``None`` (the default) costs the send path one attribute
check per priced message.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _label_for(tag: Optional[int]) -> str:
    """Traffic-class label for a message tag: the registered TAG_* name
    for reserved tags, the owning band for unregistered reserved tags,
    "app" for application tags, "switchboard" for phantom pricing."""
    if tag is None:
        return "switchboard"
    if tag >= 0:
        return "app"
    from repro_torch.analyze.tags import band_owner, reserved_tags
    name = reserved_tags().get(tag)
    if name is not None:
        return name.rsplit(".", 1)[-1].replace("TAG_", "").lower()
    owner = band_owner(tag)
    return owner.rsplit(".", 1)[-1] if owner else "reserved"


class LinkUsage:
    """Bytes / busy-time / message-count accumulator per graph link."""

    def __init__(self, cost_model):
        self.cost_model = cost_model
        self.bytes: Dict[object, int] = {}
        self.busy_s: Dict[object, float] = {}
        self.msgs: Dict[object, int] = {}
        # label -> link -> busy seconds (attribution tables)
        self.by_label: Dict[str, Dict[object, float]] = {}
        # (src_node, dst_node) -> ((link, effective_Bps), ...)
        self._paths: Dict[Tuple[int, int], tuple] = {}
        self._labels: Dict[Optional[int], str] = {}

    # -- accumulation (hot path) ---------------------------------------------

    def record(self, src_wid: int, dst_wid: int, tag: Optional[int],
               nbytes: int) -> None:
        cm = self.cost_model
        key = (cm.node_of_worker(src_wid), cm.node_of_worker(dst_wid))
        path = self._paths.get(key)
        if path is None:
            graph = cm.graph
            path = self._paths[key] = tuple(
                (link, cm.beta_Bps * graph.link_share(link))
                for link in graph.links_on_path(*key))
        if not path:
            return                       # intra-node: no network link
        label = self._labels.get(tag)
        if label is None:
            label = self._labels[tag] = _label_for(tag)
        table = self.by_label.get(label)
        if table is None:
            table = self.by_label[label] = {}
        for link, bps in path:
            self.bytes[link] = self.bytes.get(link, 0) + nbytes
            self.busy_s[link] = self.busy_s.get(link, 0.0) + nbytes / bps
            self.msgs[link] = self.msgs.get(link, 0) + 1
            table[link] = table.get(link, 0.0) + nbytes / bps

    # -- reporting -----------------------------------------------------------

    def max_contended(self, label: Optional[str] = None
                      ) -> Optional[Tuple[object, float]]:
        """(link, busy seconds) of the most contended link — overall, or
        within one traffic label's attribution table."""
        table = self.busy_s if label is None else \
            self.by_label.get(label, {})
        if not table:
            return None
        link = max(sorted(table, key=repr), key=lambda k: table[k])
        return link, table[link]

    def table(self, top: Optional[int] = None) -> List[dict]:
        """Heat table rows sorted by busy time, hottest first (JSON-safe:
        links are stringified)."""
        rows = [{
            "link": repr(link),
            "bytes": self.bytes[link],
            "busy_s": self.busy_s[link],
            "msgs": self.msgs[link],
        } for link in sorted(self.busy_s, key=repr)]
        rows.sort(key=lambda r: (-r["busy_s"], r["link"]))
        return rows[:top] if top is not None else rows

    def as_dict(self) -> dict:
        out = {"links": self.table(),
               "by_label": {
                   label: {repr(k): v for k, v in sorted(
                       tbl.items(), key=lambda kv: repr(kv[0]))}
                   for label, tbl in sorted(self.by_label.items())}}
        worst = self.max_contended()
        if worst is not None:
            out["max_contended"] = {"link": repr(worst[0]),
                                    "busy_s": worst[1]}
        return out
