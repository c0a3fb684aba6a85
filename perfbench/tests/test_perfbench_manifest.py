"""``BENCHMARK.json`` against the benchmark's contract: names, units and
text in their allowed characters, every cell's files present, bounds in
range, every per-layer metric's ``moves`` reported in its cells, a
reader for every metric, and the Mixtral configuration file holding the
published numbers but where ``reduced`` says."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|d_state|"
                   r"state_size|projection|_dim$|_rank$|headdim|head_size|"
                   r"kv_channels|expand|experts_per_tok)")


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_text():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry and isinstance(entry[key], str):
                    assert _text_ok(entry[key]), (entry["name"], key)
    for metric in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")


def test_cells_and_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        family = config["port"]["family"]
        for kind in ("work", "reference"):
            assert (ROOT / "perfbench" / kind / f"{family}.py").is_file()
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTH.search(k)]


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in MANIFEST["end_to_end"])


def _reported(metric, cell):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    mine = [m for m in MANIFEST["per_layer"] if _reported(m, cell)]
    assert mine, "a cell reports at least one per-layer metric"
    assert sum(_reported(m, cell) for m in e2e.values()) >= 2
    for m in mine:
        assert m["moves"] in e2e and _reported(e2e[m["moves"]], cell)


def test_a_reader_for_every_metric():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_mixtral_file_holds_the_published_numbers():
    """mistralai/Mixtral-8x7B-v0.1's config.json numbers, but for the keys
    listed in ``reduced`` (depth alone); the port's sizes as the file
    states them."""
    config = json.loads(
        (ROOT / "perfbench/configs/mixtral-8x7b-1layer.json").read_text())
    reduced = next(c["reduced"] for c in MANIFEST["configs"]
                   if c["name"] == "mixtral-8x7b-1layer")
    assert reduced == ["num_hidden_layers"]
    published = {"hidden_size": 4096, "intermediate_size": 14336,
                 "num_attention_heads": 32, "num_key_value_heads": 8,
                 "num_local_experts": 8, "num_experts_per_tok": 2,
                 "vocab_size": 32000, "rms_norm_eps": 1e-05,
                 "rope_theta": 1e6, "router_aux_loss_coef": 0.02,
                 "max_position_embeddings": 32768, "num_hidden_layers": 32}
    for key, value in published.items():
        assert (config[key] == value) != (key in reduced), key
    port = config["port"]
    assert (port["d_model"], port["d_ff"], port["n_experts"],
            port["n_experts_per_tok"], port["n_heads"], port["n_kv_heads"],
            port["vocab_size"]) == (4096, 14336, 8, 2, 32, 8, 32000)
    assert port["n_layers"] == config["num_hidden_layers"]
