"""Every file of the benchmark parses and is found by name; a new cell
needs new files and entries alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from conftest import PORTBENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(Path(ROOT) / "BENCHMARK.json") as fh:
        return json.load(fh)


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(b["workloads"]) // 4)
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in names
            names.add(m["name"])
    assert "setup_s" in names
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "traffic"])
def test_every_config_and_traffic_parses(kind):
    b = bench()
    if kind == "configs":
        for c in b["configs"]:
            with open(Path(ROOT) / c["file"]) as fh:
                conf = json.load(fh)
            assert conf["name"] == c["name"] and conf["source"] == c["source"]
            assert set(conf["reduced"]) == set(c["reduced"])
            assert conf["assumed"] and conf["inputs"] in ("files", "device")
            for key, cut in conf["reduced"].items():
                assert {"source", "here", "why"} <= set(cut)
    else:
        for w in b["workloads"]:
            with open(Path(PORTBENCH) / "traffic" / f"{w['traffic']}.json") as fh:
                tr = json.load(fh)
            assert len(tr["na_rates"]) == tr["traits"]
            assert tr["block_size"] % tr["wave"] == 0
            assert tr["dtype"] in ("float32", "float64")


def test_every_cell_resolves_by_name():
    from pbcore import spec
    b = bench()
    for w in b["workloads"]:
        c = spec.cell(w["name"])
        names = {m.name for m in c.metrics}
        assert {"gibbs_markers_per_s", "setup_s"} <= names
        if c.chips > 1:         # one shard a process and a card
            assert c.config["shards"] == c.chips
            assert "replica_mismatch" in c.limits
        assert {"beta_gap", "eps_gap", "hyper_gap", "record_mismatch"} <= set(c.limits)


def test_a_cell_is_added_with_new_files_alone(tmp_path):
    """Copy the benchmark, add a traffic mix, a limits file, a metric and
    a cell entry, and find them all by name; no file that was there
    changes."""
    from pbcore import spec
    root = tmp_path / "checkout"
    shutil.copytree(PORTBENCH, root / "portbench")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    b = bench()
    base = root / "portbench"
    tr = json.loads((base / "traffic" / "w32.json").read_text())
    (base / "traffic" / "w16.json").write_text(json.dumps(dict(tr, wave=16)))
    (base / "limits" / "sim10k_100k.w16.json").write_text(
        (base / "limits" / "sim10k_100k.w32.json").read_text())
    (base / "metrics" / "iterations.py").write_text(
        "def read(run):\n    return run['iterations']\n")
    b["workloads"].append({"name": "sim10k_100k.w16", "config": "sim10k_100k",
                           "traffic": "w16", "chips": 1, "why": "W = 16"})
    b["per_layer"].append({"name": "iterations", "unit": "iterations",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "gibbs_markers_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.cell("sim10k_100k.w16", base=base, root=root)
    assert c.traffic["wave"] == 16
    reader = {m.name: m for m in c.metrics}["iterations"].read
    assert reader({"iterations": 7}) == 7
    for p, data in before.items():
        assert p.read_bytes() == data


def test_metric_readers_leave_out_what_they_cannot_read():
    from pbcore import spec
    run = {"markers": 100, "iterations": 10, "window_s": 2.0,
           "intervals_s": [0.1] * 10, "setup_s": 3.0,
           "spans": {"build_static": 1.0}, "records_s": []}
    c = spec.cell("ukb400k_1m_share.w32")
    e2e = spec.values(c, run, True)
    assert e2e["gibbs_markers_per_s"]["value"] == 500.0
    assert "iter_ms_p95" not in e2e
    layer = spec.values(c, run, False)
    assert set(layer) == {"startup.static_s"}
