"""The benchmark's files: every cell's deployment, mix and metric reader is
found by the name ``BENCHMARK.json`` gives it, and nothing the benchmark
runs, the plain reference least of all, imports JAX or the packages it
compares."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    from market_bench import harness, load

    _, got, cfg, params = harness.cell_spec(cell["name"], ROOT)
    assert got is not None and harness.cell_class(cfg["kind"]).__name__ == "Cell"
    assert params == load.mix(cell["traffic"])
    assert set(cfg["limits"]) and all(v >= 0 for v in cfg["limits"].values())
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    from market_bench import trace

    t = trace.Tracer(__import__("torch").device("cpu"))
    assert trace.read_metric(metric["name"], t) is None  # nothing to read: no number
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_benchmark_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("market_bench/")
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_it_judges(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py")
                                        if not p.name.startswith("test_")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_benchmark_imports_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("submits,withdraws", [(1000, 100), (1050, 100), (10, 0), (3, 7)])
def test_a_batch_holds_what_its_mix_asks(submits, withdraws):
    import numpy as np

    from market_bench import load

    n = 50
    rows = ([f"agent-{i}" for i in range(n)], np.zeros((n, 2, 3), np.int32),
            np.ones((n, 2, 3), np.float32), np.ones((n, 2), bool), np.ones((n, 2), np.float32))
    params = {"submits": submits, "withdraws": withdraws, "wtp_scale": [0.9, 1.1]}
    kinds = [[k for k, _, _ in load.Clients(rows, params, seed).batch()] for seed in (1, 2 ** 33)]
    for got in kinds:
        assert got.count("submit") == submits and got.count("withdraw") == withdraws


def test_fault_spec_fills_every_field_and_refuses_unknown_ones():
    from market_bench import load

    assert load.fault_spec({}, 1) is None
    spec = load.fault_spec({"faults": {"bid_dropout": 0.1}}, 7)
    assert spec["seed"] == 7 and spec["pool_fail_scale"] == 0.5 and spec["region_faults"] == []
    with pytest.raises(ValueError):
        load.fault_spec({"faults": {"bid_dropoot": 0.1}}, 7)
