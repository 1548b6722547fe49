"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import bench

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("d_model", "d_ff", "moe_d_ff", "head_dim", "num_heads",
          "num_kv_heads", "experts_per_token", "frontend_dim", "vocab_size")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load_by_name(cell):
    f = bench.cell_files(SPEC, cell)
    assert f["cell"]["chips"] in (1, 4)
    assert NAME.match(cell) and NAME.match(f["cell"]["traffic"])
    assert 1 <= len(f["cell"]["why"]) <= 200
    t = f["traffic"]
    assert t["batch"] > 0 and t["seq_len"] % 512 == 0
    assert set(f["workload"]["limits"]) >= {"loss_gap", "grad_gap",
                                            "change_gap"}
    ends = {m["name"] for m in bench.metrics_for(SPEC, cell, False)}
    assert "setup_s" in ends and len(ends) >= 2
    assert bench.metrics_for(SPEC, cell, True)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("portbench/configs/")
    c = json.loads((ROOT / conf["file"]).read_text(encoding="utf-8"))
    assert c["source"] == conf["source"]
    assert c["reduced"] == conf["reduced"]
    assert not set(conf["reduced"]) & set(WIDTHS)
    for key in conf["reduced"]:
        assert c["published"][key] != c["model"][key]
    bench.model_config(c["model"])            # a config the port takes


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    path = ROOT / "portbench" / "metrics" / f"{m['name']}.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(n.value, ast.Constant)}
    assert callable(bench.load_reader(m["name"]))
    if "layer" in m:
        assert consts.get("LAYER") == m["layer"]
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    else:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_each_cell_reports_a_per_layer_metric_of_its_own_end_to_end():
    for w in SPEC["workloads"]:
        ends = {m["name"] for m in bench.metrics_for(SPEC, w["name"], False)}
        for m in bench.metrics_for(SPEC, w["name"], True):
            assert m["moves"] in ends, (w["name"], m["name"])
