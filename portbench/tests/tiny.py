"""A tiny copy of the benchmark's data files, for runs on the CPU: the same
cells, drivers and metrics, with the models cut to a few channels and the
traffic to fractions of a second."""

from __future__ import annotations

import copy
import json
import os

from portbench import harness

SERVE, VOCODE, TRAIN = ("binaural256x-serve-clip10s", "bigvgan22k-vocode-ljs",
                        "binaural256x-train-gan-b32")


def write_tiny_root(root: str) -> str:
    """Write a tiny ``BENCHMARK.json`` and data files under ``root``."""
    manifest = harness.load_manifest()
    os.makedirs(os.path.join(root, "portbench"), exist_ok=True)
    for entry in manifest["configs"]:
        h = dict(harness.read_json(entry["file"]), upsample_initial_channel=64)
        if "stage1" in h:
            h["stage1"].update(dim=16, attn_heads=2, attn_dim_head=8,
                               context_dim=32, window=16, stride=8,
                               crop_frames=2, sampling_timesteps=3)
            h.update(cqtd_filters=8, mpd_reshapes=[2, 3])
        _dump(root, entry["file"], h)
    for cell in manifest["workloads"]:
        traffic = harness.read_json(os.path.join(
            "portbench", "workloads", cell["traffic"] + ".json"))
        traffic = copy.deepcopy(traffic)
        if traffic["driver"] == "serve_clip":
            traffic.update(clip_seconds=0.2, unet_batch=2, pool=2,
                           check_requests=2)
        elif traffic["driver"] == "vocode":
            traffic.update(seconds_min=0.06, seconds_max=0.23,
                           seconds_mean=0.16, lengths=4,
                           pad_multiple=8, trace_requests=3,
                           check_requests=3)
        else:
            traffic.update(batch=4, segment=2048, reference_block=2,
                           trace_requests=1)
        _dump(root, os.path.join("portbench", "workloads",
                                 cell["traffic"] + ".json"), traffic)
        limits = harness.read_json(os.path.join(
            "portbench", "limits", cell["name"] + ".json"))
        _dump(root, os.path.join("portbench", "limits",
                                 cell["name"] + ".json"), limits)
    _dump(root, "BENCHMARK.json", manifest)
    return root


def _dump(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def run(root, cell, seed=1, seconds=0.5, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            root=root)
