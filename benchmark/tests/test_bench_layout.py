"""BENCHMARK.json against the benchmark's contract: names, units and
lengths; every configuration, traffic mix, limit file and per-layer metric
found by its name; the roofline counts on hand-worked inputs."""
import json
import os
import re

import pytest

from benchmark import roofline, run
from benchmark import traffic as tr

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark()


def test_keys_and_lengths(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    path = os.path.join(run.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_bounds_and_sources(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert all(w in e2e[m["moves"]].get("workloads", [w])
                   for w in m["workloads"])


def test_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(run.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and "assumed" in cfg
    for w in bench["workloads"]:
        for kind, name in (("traffic", w["traffic"]),
                           ("limits", w["name"])):
            assert os.path.exists(os.path.join(HERE, kind, name + ".json"))
        e2e, per_layer = run.cell_metrics(
            bench, w["name"], tr.load("traffic", w["traffic"])["rate_metric"])
        assert "setup_s" in e2e and per_layer
    for m in bench["per_layer"]:
        stems = (m["name"], m["name"].rsplit(".", 1)[0])
        assert any(os.path.exists(os.path.join(HERE, "metrics", s + ".py"))
                   for s in stems), m["name"]


def test_roofline_hand_worked():
    # detection: B = 2, n_pad = 512, K = 8, 1000 admissible pairs
    assert roofline.detect(2, 512, 8, 1000) == (
        2 * 8 * 512 * 4 + 512 * 512 + 2 * 512 * 9 * 4, 2 * 1000 * 20)
    # the forward sweep: B = 2, n = 10, TC = 256, 4 layers, 7 active slots
    assert roofline.friction_fwd(2, 10, 256, 4, 7) == (13024, 7 * 45)
    assert roofline.friction_bwd(2, 10, 256, 4, 7) == (7048, 7 * 114)
    assert roofline.least_s(3.35e12, 0) == 1.0
    assert roofline.least_s(0, 67e12) == 1.0
    assert roofline.least_s(3.35e12, 2 * 67e12) == 2.0
