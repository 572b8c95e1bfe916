"""Every cell of BENCHMARK.json resolves by name to its files, and a new
cell is a new traffic file and an entry alone."""
import json
import shutil

import pytest

from perfbench import bench, harness
from perfbench.tests import smoke


def test_every_cell_resolves():
    b = bench.load_benchmark()
    ops = bench.ops()
    assert set(ops) >= {"flash_fwd", "flash_bwd", "ssd_fwd", "ssd_bwd"}
    for w in b["workloads"]:
        cell = bench.cell(w["name"], b)
        assert cell.traffic["kind"] in ("train", "serve")
        assert cell.family.leaf_specs(cell.config["model"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench.metric_reader(m["name"]).read)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_contract_shapes():
    b = bench.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert w in e.get("workloads", [w])
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        assert bench.load_json(bench.ROOT / c["file"])["reduced"] == \
            c["reduced"]
    assert all(w["chips"] in (1, 4) for w in b["workloads"])


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    shutil.copytree(bench.ROOT / "perfbench", tmp_path / "perfbench")
    b = bench.load_benchmark()
    mix = json.loads((tmp_path / "perfbench" / "traffic"
                      / "carousel_8x2048.json").read_text())
    mix["rows"] = 4
    mix["cold"].update(straggler_frac=0.05, straggler_mult=4.0)
    mix["stager"].update(hedge_factor=2.0)
    mix["delivery"].update(prefetch=3)
    (tmp_path / "perfbench" / "traffic" / "carousel_4x2048.json").write_text(
        json.dumps(mix))
    b["workloads"].append({"name": "yi-6b.train.carousel4", "config": "yi-6b",
                           "traffic": "carousel_4x2048", "chips": 1,
                           "why": "a test cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "yi-6b.train.carousel" in m.get("workloads", []):
            m["workloads"].append("yi-6b.train.carousel4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.cell("yi-6b.train.carousel4", root=tmp_path)
    assert cell.traffic["rows"] == 4
    small = smoke.shrink(cell)
    res = smoke.run(small)
    assert set(res["metrics"]) == {"train_tok_per_s", "setup_s"}
    assert res["attempted"] >= 1


@pytest.mark.parametrize("name", ["setup_s", "mfu.train",
                                  "data_wait_ms.train", "nonexistent"])
def test_metric_reader_by_name(name):
    if name == "nonexistent":
        with pytest.raises(FileNotFoundError):
            bench.metric_reader(name)
    else:
        assert callable(bench.metric_reader(name).read)


def test_readers_return_nothing_without_data():
    cell = bench.cell("yi-6b.serve.longprompt")
    rec = harness.Record(cell, 0.0)
    for m in cell.per_layer:
        assert bench.metric_reader(m["name"]).read(rec) is None


def test_readers_of_a_four_card_cell_return_nothing_without_data():
    cell = bench.cell("mixtral-8x7b.serve.tp4")
    assert cell.chips == 4
    names = {m["name"] for m in cell.per_layer}
    assert names == {"mfu.prefill", "flash_roofline.prefill"}
    rec = harness.Record(cell, 0.0)
    for m in cell.per_layer:
        assert bench.metric_reader(m["name"]).read(rec) is None
