"""A cell at a size a CPU test run holds: every width cut, float32, on a
bench directory of its own (configuration, traffic, limits, manifest)."""

import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from multi_modal_transformers_tokenmerge_torch import load_config  # noqa: E402

TINY = ["token_embedding_dim=64", "text.embedding_dim=64",
        "text.t5_num_layers=2", "text.t5_num_heads=2", "text.t5_d_kv=32",
        "text.t5_d_ff=128", "text.vocab_size=100", "images.embedding_dim=64",
        "images.resnet.output_features=64",
        "transformer.attention.qkv_features=64",
        "transformer.attention.num_heads=2", "transformer.mlp_dim=128",
        "heads.diffusion.time_dim=64", "heads.diffusion.mlp_dim=64"]
PRESETS = {
    "deep": ("octo_deep", TINY + ["transformer.attention_impl=flash"]),
    # a denoiser wide enough for the tied output layer of ``weights.py`` to
    # make the 100-step loop contract, as at the cell's 3072
    "chunk": ("octo_base", TINY[:-1] + ["heads.diffusion.mlp_dim=768",
                                        "heads.diffusion.action_space_dim=28",
                                        "heads.diffusion.diffusion_steps=100"]),
}


def model_of(preset, overrides):
    cfg = load_config(preset, overrides)
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def bench(tmp: Path, which: str = "deep", batch: int = 2,
          limit: float = 0.03) -> Path:
    """Write a tiny cell ``tiny.t`` into ``tmp``; returns the manifest."""
    preset, overrides = PRESETS[which]
    for kind in ("configs", "traffic", "limits"):
        (tmp / kind).mkdir(parents=True, exist_ok=True)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(
        {"preset": preset, "overrides": overrides,
         "model": model_of(preset, overrides)}))
    (tmp / "traffic" / "t.json").write_text(json.dumps(
        {"driver": "fleet_tick", "batch": batch, "pool": 3,
         "warmup_s": 0.05, "check_rows": 2 * batch}))
    (tmp / "limits" / "tiny.t.json").write_text(json.dumps(
        {"actions_rms_rel": limit}))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["workloads"] = [{"name": "tiny.t", "config": "tiny",
                              "traffic": "t", "chips": 1, "why": "a test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return path
