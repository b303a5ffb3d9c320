"""The port's drives (``multi_modal_transformers_tokenmerge_torch/
examples``) on the CPU, each in a subprocess as a user runs it, with the
JAX drives' flags and messages.

The fault-tolerance drive of the JAX package's ``examples/train_octo.py``:
a run with ``--ckpt --recordio``, a ``--resume`` (here with ``--remat``
and ``--accum-steps 2``) that prints ``resumed train state from step N``
and ``resumed data stream at batch M`` (M = N + the prefetch depth of 2:
the prefetched batches count as read), and a long run that takes a
SIGTERM once it is training and still saves, prints ``final:`` and exits
0.  Then the serve drive."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = "multi_modal_transformers_tokenmerge_torch.examples.train_octo"
SERVE = "multi_modal_transformers_tokenmerge_torch.examples.serve_octo"
TIMEOUT = 60.0


def _env():
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(module, *args):
    out = subprocess.run([sys.executable, "-m", module, "--device", "cpu",
                          *args], cwd=ROOT, env=_env(), timeout=TIMEOUT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    assert out.returncode == 0, out.stdout
    return out.stdout


def _final(text):
    lines = [l for l in text.splitlines() if l.startswith("final:")]
    assert len(lines) == 1, text
    return lines[0]


def test_train_drive_resumes_and_stops_on_sigterm(tmp_path):
    t0 = time.monotonic()
    ckpt, rec = str(tmp_path / "ckpt"), str(tmp_path / "data.rec")
    common = ["--batch", "2", "--ckpt", ckpt, "--recordio", rec]
    first = _run(TRAIN, "--steps", "4", *common)
    assert "wrote 64 synthetic records" in first
    _final(first)
    assert sorted(os.listdir(ckpt)) == ["4.metrics.json", "4.pt",
                                        "data_state"]

    resumed = _run(TRAIN, "--steps", "2", "--resume", "--remat",
                   "--accum-steps", "2", *common)
    assert "resumed train state from step 4" in resumed
    assert "resumed data stream at batch 6" in resumed
    _final(resumed)
    assert "6.pt" in os.listdir(ckpt)

    proc = subprocess.Popen(
        [sys.executable, "-m", TRAIN, "--device", "cpu", "--steps",
         "100000", "--resume", *common], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seen = []
    try:
        # the first metrics line (step 25 of this run) means fit is
        # running, graceful_stop's handlers in place
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("{") and '"loss"' in line:
                break
            assert time.monotonic() - t0 < TIMEOUT, "".join(seen)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(seen) + rest
    assert proc.returncode == 0, text
    assert "resumed train state from step 6" in text
    # the second run resumed at batch 6, took 2 and prefetched 2 more
    assert "resumed data stream at batch 10" in text
    _final(text)
    logged = json.loads(next(l for l in seen if l.startswith("{")))
    stopped = max(int(m.group(1)) for m in
                  map(re.compile(r"^(\d+)\.pt$").match, os.listdir(ckpt))
                  if m)
    assert stopped >= logged["step"] > 6
    assert time.monotonic() - t0 < TIMEOUT


@pytest.mark.parametrize("extra", [[], ["--preset", "octo_small",
                                        "--batch", "2", "--requests", "4"]],
                         ids=["octo_tiny", "octo_small"])
def test_serve_drive(extra):
    out = _run(SERVE, "--requests", "8", *extra)
    assert "AOT compile:" in out
    assert "instruction cached" in out
    assert re.search(r"\d+ requests in \d+ms \(p50 latency [\d.]+ms\); "
                     r"sample action: \[", out), out


def test_serve_drive_refuses_ddim_without_the_diffusion_head():
    out = subprocess.run([sys.executable, "-m", SERVE, "--device", "cpu",
                          "--ddim-steps", "4"], cwd=ROOT, env=_env(),
                         timeout=TIMEOUT, capture_output=True, text=True)
    assert out.returncode == 2 and "--ddim-steps requires" in out.stderr


def test_apply_overrides_sets_the_presets_fields():
    """The drives' ``--override``: dotted fields of the preset's config,
    values parsed as YAML, as the CLI's config overrides."""
    from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import (
        apply_overrides)
    from multi_modal_transformers_tokenmerge_torch.models.presets import (
        get_preset)
    cfg = get_preset("octo_deep")
    got = apply_overrides(cfg, ["dtype=bfloat16",
                                "transformer.attention_impl=flash",
                                "transformer.remat=true"])
    assert got == cfg.replace(dtype="bfloat16",
                              transformer=cfg.transformer.replace(
                                  attention_impl="flash", remat=True))
    assert apply_overrides(cfg, []) is cfg
    assert apply_overrides(cfg, [" dtype = bfloat16 "]).dtype == "bfloat16"
    with pytest.raises(ValueError, match="need load_config"):
        apply_overrides(cfg, ["transformer=deep"])
    with pytest.raises(ValueError, match="key=value"):
        apply_overrides(cfg, ["dtype"])
    with pytest.raises(KeyError, match="unknown field"):
        apply_overrides(cfg, ["transformer.no_such_field=1"])
