"""A benchmark tree of its own for the CPU tests: BENCHMARK.json with cells
of a tiny ADE20k-like configuration (64 px, ngf 8, 12 classes) in each of
the harness's modes, their traffic and configuration files, and the
repository's metric readers, added by files alone as a later cell would
be."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

MODEL = {"label_mode": "ids", "semantic_nc": 12, "ngf": 8, "ndf": 8,
         "crop_size": 64, "maskmix": True, "warp_mask_losstype": "direct",
         "adaptor_kernel": 3, "warp_patch": False, "warp_bilinear": False,
         "vgg_normal_correct": True, "weight_mask": 100.0, "PONO": True,
         "PONO_C": True, "match_kernel": 3, "n_layers_D": 4, "num_D": 2,
         "novgg_featpair": 10.0, "weight_gan": 10.0, "lambda_feat": 10.0,
         "lambda_vgg": 10.0, "fm_ratio": 0.1, "weight_perceptual": 0.01,
         "ctx_w": 1.0, "lr": 0.0002, "ema_beta": 0.999, "use_ema": True}
FLAGS = ["--dataset_mode", "ade20k", "--label_nc", "11", "--use_attention",
         "--maskmix", "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
         "--ngf", "8", "--ndf", "8", "--crop_size", "64", "--load_size",
         "64", "--vgg_normal_correct", "--use_ema", "--weight_mask", "100"]
INPUTS = {"blobs": 4, "grid": 4, "self_ref": 0.5}
CELLS = {
    "tiny.infer-b2": {"mode": "serve", "batch": 2, "pool": 3, "sample": 2,
                      "trace_units": 2,
                      "limits": {"image_mad": 4.0}},
    "tiny.request-b1": {"mode": "request", "batch": 1, "pool": 3,
                        "sample": 3, "trace_units": 2,
                        "limits": {"image_mad": 4.0}},
    "tiny.train-b2": {"mode": "train", "batch": 2, "chunk": 2, "pool": 5,
                      "trace_units": 2,
                      "limits": {"loss_gap": 0.02, "change_gap": 0.05,
                                 "ema_gap": 0.05, "replay_loss_gap": 0.02,
                                 "replay_change_gap": 0.05}},
}
METRIC = {"infer": "infer_images_per_s", "request": "request_p95_ms",
          "train": "train_images_per_s"}
UNIT = {"infer": "images/s", "request": "ms", "train": "images/s"}


def make_root(tmp: str, cells=CELLS) -> str:
    """A checkout-shaped tree under tmp: BENCHMARK.json naming `cells`,
    benchmark/configs/tiny.json, benchmark/workloads/<cell>.json and the
    repository's benchmark/metrics/."""
    root = os.path.join(tmp, "root")
    os.makedirs(os.path.join(root, "benchmark", "configs"))
    os.makedirs(os.path.join(root, "benchmark", "workloads"))
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(root, "benchmark", "metrics"))
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"),
              "w") as f:
        json.dump({"flags": FLAGS, "model": MODEL}, f)
    workloads = []
    for name, spec in cells.items():
        traffic = name.split(".", 1)[1]
        with open(os.path.join(root, "benchmark", "workloads",
                               name + ".json"), "w") as f:
            json.dump({"config": "tiny", "traffic": traffic,
                       "inputs": INPUTS, **spec}, f)
        workloads.append({"name": name, "config": "tiny", "traffic": traffic,
                          "chips": 1, "why": "CPU test"})
    kinds = {n: n.split(".", 1)[1].split("-")[0] for n in cells}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    e2e = [{"name": METRIC[k], "unit": UNIT[k], "better": "higher",
            "bound": 0.05, "source": "host_clock", "workloads": [n]}
           for n, k in kinds.items()]
    e2e.append({"name": "setup_s", "unit": "s", "better": "lower",
                "bound": 0.25, "source": "host_clock"})
    per_layer = [{"name": "mfu." + k, "unit": "%", "better": "higher",
                  "source": "host_clock", "layer": "whole step",
                  "moves": METRIC[k], "workloads": [n]}
                 for n, k in kinds.items()]
    bench = {**real, "configs": [{"name": "tiny", "source": "test",
                                  "file": "benchmark/configs/tiny.json",
                                  "reduced": [], "why": "CPU test"}],
             "workloads": workloads, "end_to_end": e2e,
             "per_layer": per_layer}
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
