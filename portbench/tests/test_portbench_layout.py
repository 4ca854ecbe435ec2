"""The harness finds what a later change adds as files alone, and the
isolation check compares whole top-level names."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    # the files a later change adds ...
    cfg = json.loads((root / "portbench/configs/ad-refine-n.json").read_text())
    (root / "portbench/configs/ad-refine-s.json").write_text(json.dumps(dict(cfg, scale="s")))
    traffic = json.loads((root / "portbench/traffic/serve-b32.json").read_text())
    (root / "portbench/traffic/serve-b16.json").write_text(json.dumps(dict(traffic, batch=16)))
    (root / "portbench/metrics/serve.batches.py").write_text(textwrap.dedent('''
        def read(run):
            return run.out["batches"]
    '''))
    # ... and the entries it adds
    spec["configs"].append({"name": "ad-refine-s", "source": "x", "reduced": [], "why": "x",
                            "file": "portbench/configs/ad-refine-s.json"})
    spec["workloads"].append({"name": "ad-refine-s.serve-b16", "config": "ad-refine-s",
                              "traffic": "serve-b16", "chips": 1, "why": "x"})
    spec["end_to_end"][1]["workloads"].append("ad-refine-s.serve-b16")
    spec["per_layer"].append({"name": "serve.batches", "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "Predictor",
                              "moves": "serve_images_per_s",
                              "workloads": ["ad-refine-s.serve-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = harness.cell("ad-refine-s.serve-b16", root=root)
    assert c["config"]["scale"] == "s" and c["traffic"]["batch"] == 16
    assert c["config"]["yaml_path"] == str(root / cfg["yaml"])
    assert [m["name"] for m in c["end_to_end"]] == ["serve_images_per_s", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in c["per_layer"]] == ["serve.batches"]
    run = type("Run", (), {"out": {"batches": 7}})()
    assert harness.metric_reader("serve.batches", root=root)(run) == 7
    # a cell it does not name keeps its own metrics
    assert "serve.batches" not in [m["name"] for m in
                                   harness.cell("ad-refine-n.serve-b32", root=root)["per_layer"]]


def test_isolation_compares_whole_top_level_names(monkeypatch):
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "yolo_ad_refine_tpu_torch.fake", sys)
    assert harness.loaded_forbidden() == []
    for name in ("jax.numpy", "flax", "optax", "jaxlib.xla", "yolo_ad_refine_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name.split(".")[0] in harness.loaded_forbidden()


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import portbench.reference.model, portbench.reference.loss, "
            "portbench.reference.train, portbench.reference.postprocess, "
            "portbench.reference.precision, portbench.weights, portbench.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))  # noqa: S307 - our own printout
    assert not tops & {"jax", "jaxlib", "flax", "optax", "yolo_ad_refine_tpu",
                       "yolo_ad_refine_tpu_torch"}


def test_benchmark_file_keeps_the_contract():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        c = harness.cell(w["name"])
        names = [m["name"] for m in c["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_every_metric_reader_reads_a_traced_run():
    from portbench.trace import Spans

    spans = Spans()
    spans.window = {"pb.step": [1.0, 3.0], "pb.data": [0.002]}
    shapes = [[48, 384, 80, 80], [48, 18, 80, 80], [48, 9, 80, 80], [384, 384, 3, 3]]
    trace = {"window_s": 2.0, "busy_s": 1.5, "kernels": 400, "steps": 4, "batches": 8,
             "images": 64, "families": {"K1_dcn_forward": 0.01, "K1_dcn_backward": 0.1,
                                        "K4_nms_suppress": 0.001},
             "ops": [{"name": "yat_ad::dcn_forward", "shapes": shapes, "dtypes": ["c10::BFloat16"]},
                     {"name": "yat_ad::dcn_backward", "shapes": shapes, "dtypes": ["c10::BFloat16"]}],
             "valid": [40, 30], "kept": [20, 10], "idle_gaps": {}}
    c = harness.cell("ad-refine-x.train-b48")
    run = type("Run", (), {"config": c["config"], "spans": spans, "trace": trace,
                           "out": {"e2e": {"train_images_per_s": 40.0,
                                                   "serve_images_per_s": 100.0}}})()
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        v = harness.metric_reader(m["name"])(run)
        assert isinstance(v, float) and v > 0, m["name"]
        if m["unit"] == "%":
            assert v <= 100.0, (m["name"], v)
    assert harness.metric_reader("train.device_idle_pct")(run) == pytest.approx(25.0)
    assert harness.metric_reader("train.enqueue_ms")(run) == pytest.approx(2000.0)
    trace["valid"], trace["kept"] = [0, 0], [0, 0]  # no candidate: K4's reader has nothing
    assert harness.metric_reader("serve.k4_roofline_pct")(run) is None
