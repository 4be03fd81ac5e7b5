"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each entry is found by, and the readers' declarations."""
import json
import re

import pytest

from pb_paths import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_paths(man):
    assert set(man) == TOP
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells (14 runs each, 2 more) fits 43,200 seconds
    assert (2 + 14 * 24) * (man["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(man).encode()) <= 64 * 1024


def test_names_units_and_whys(man):
    names = []
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in man[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and _line(e["why"])
            names.append(e["name"])
    for e in man["configs"]:
        assert _line(e["source"]) and len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                       e["reduced"])
    for e in man["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert e["chips"] in (1, 4)
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) \
        == len(man["workloads"])


def test_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert set(e2e) == {"train_tokens_per_s", "train_mfu",
                        "train_step_ms_p90", "setup_s"}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", reporting)) <= reporting & cells
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for w in cells:
        per = [m for m in man["per_layer"] if w in m.get("workloads", cells)]
        assert per, w


def test_every_entry_finds_its_files(man):
    for c in man["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        with open(REPO / c["file"]) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in man["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        with open(BENCH / "limits" / f"{w['name']}.json") as f:
            assert json.load(f)["limits"]
    assert (REPO / man["command"][1]).is_file()


def test_readers_declare_what_the_manifest_says(man):
    import harness
    for w in man["workloads"]:
        for m, mod in harness.load_readers(man, w):
            assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) \
                == (m["name"], m["unit"], m["layer"], m["source"],
                    m["moves"])
