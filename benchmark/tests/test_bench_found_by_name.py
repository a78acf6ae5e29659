"""A new configuration, family, traffic mix, loop, per-layer metric and cell
are new files and new entries only: the harness finds each by its name."""

import json
import shutil

import tiny
from benchmark import harness, spec

NEW_SYSTEM = '''"""A pixel-space IR-SDE on a NAFNet, sampled eagerly (no CUDA graph)."""

from benchmark.reference.sde import truncated


class System:
    def build(self, run):
        from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
        from image_restoration_sde_tpu_torch.sde import IRSDE

        net = run.port_net("score", run.config["score_net"])
        sde = IRSDE.create(device=run.device, **run.config["sde"])
        sampler = make_restoration_sampler(sde, net, mode=run.mode, capture=False)
        sampler.prepare = lambda lq, gen: None
        return sampler

    def noise_shape(self, run, batch, H, W):
        return (batch, H, W, 3)

    def reference_call(self, ref, x, noise, mode, steps=None):
        return truncated(ref["sde"], steps).reverse(ref["score"], x, noise, mode)
'''

NEW_REFERENCE = '''import torch

from benchmark.reference import nets, sde


def build(config, device, prec):
    with torch.device(device):
        net = nets.network(config["score_net"], "ConditionalNAFNet", prec)
    return {"score": net, "sde": sde.IRSDE(device=device, **config["sde"])}
'''

NEW_LOOP = '''"""A closed loop whose caller waits ``pause_s`` after each answer."""

import time

from benchmark import spec

closed = spec.load_module(spec.BENCH_DIR / "loops" / "closed_loop.py", "closed_loop_base")


class Loop(closed.Loop):
    def call(self, i):
        out = super().call(i)
        time.sleep(float(self.traffic["pause_s"]))
        return out
'''


def test_new_files_and_entries_make_a_new_cell(tmp_path, monkeypatch):
    bench = tiny.copy_tiny(tmp_path / "bench")
    base = tmp_path / "bench"
    monkeypatch.setattr(spec, "BENCH_DIR", base)
    # a configuration of a new family: its file, its plain reference and its system
    config = json.loads((base / "configs" / "irsde-derain.json").read_text())
    config.update(name="nafnet-pixel", system="nafnet_eager")
    config["score_net"] = {"which": "ConditionalNAFNet", "compute_dtype": "bfloat16",
                           "setting": {"img_channel": 3, "width": 16, "middle_blk_num": 1, "enc_blk_nums": [1, 1],
                                       "dec_blk_nums": [1, 1]}}
    (base / "configs" / "nafnet-pixel.json").write_text(json.dumps(config))
    (base / "reference" / "nafnet-pixel.py").write_text(NEW_REFERENCE)
    (base / "systems" / "nafnet_eager.py").write_text(NEW_SYSTEM)
    # a traffic mix driven by a new loop: a data file and the loop's code
    traffic = json.loads((base / "traffic" / "closed-rain100h.json").read_text())
    traffic.update(loop="paced_loop", batch=2, size=[12, 20], mode="posterior", pause_s=0.01)
    (base / "traffic" / "paced-b2.json").write_text(json.dumps(traffic))
    (base / "loops" / "paced_loop.py").write_text(NEW_LOOP)
    # a per-layer metric: a reader of its own
    (base / "metrics" / "calls.sample.py").write_text(
        "def read(ctx):\n    return ctx.window['units'] if ctx.window['kind'] == 'sample' else None\n")
    # the cell's limits, and the entries
    shutil.copy(base / "limits" / "derain-sample-rain100h.json", base / "limits" / "nafnet-paced-b2.json")
    bench["configs"].append({"name": "nafnet-pixel", "source": "https://example.org/nafnet", "reduced": [],
                             "file": "benchmark/configs/nafnet-pixel.json", "why": "a test"})
    bench["workloads"].append({"name": "nafnet-paced-b2", "config": "nafnet-pixel", "traffic": "paced-b2",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls.sample", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "img_per_s", "workloads": ["nafnet-paced-b2"]})

    cell = spec.Cell(bench, "nafnet-paced-b2", base=base)
    assert cell.config["score_net"]["which"] == "ConditionalNAFNet" and cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["img_per_s", "setup_s"]
    assert "calls.sample" in [m["name"] for m in cell.per_layer]
    line = harness.run(cell, 3, 0.2, True, "cpu", 0.0)
    assert line["correct"], line["checked"]
    assert line["metrics"]["calls.sample"]["value"] >= 1
    line = harness.run(cell, 3, 0.2, False, "cpu", 0.0)
    assert set(line["metrics"]) == {"img_per_s", "setup_s"}
    assert line["metrics"]["img_per_s"]["value"] < 2 / 0.01  # the pause is in the window


def test_every_entry_of_benchmark_json_has_its_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.reference().build
        assert cell.system().System and cell.loop().Loop
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.metric(m["name"]).read)
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
