"""The check that decides ``correct``: a sound run passes; the control
(the reference with float8 operands in the program's place) and every
fault a serving cell can have fail, in the head, in its answers and in
the transformer stack.  At a tiny float32 size on the CPU:
the harness's look for a card is skipped, the rest of a run is driven,
and the limit is the cells' own."""

import json
from pathlib import Path

import pytest
import torch

import multi_modal_transformers_tokenmerge_torch.heads.diffusion as head
from portbench import harness
from portbench.drivers.fleet_tick import Workload
from portbench.tests.tiny import bench
from portbench.tools.faults import planted

LIMITS = json.loads((Path(__file__).resolve().parents[1] / "limits"
                     / "octo_deep.serve_b8.json").read_text())
SEED = 2**32 + 17


def run(tmp_path, capsys, planted=None, which="deep"):
    manifest = bench(tmp_path, which, limit=LIMITS["actions_rms_rel"])
    rc = harness.main(["--workload", "tiny.t", "--seed", str(SEED),
                       "--seconds", "0.3", "--trace", "0"], device="cpu",
                      bench_dir=tmp_path, manifest_path=manifest,
                      planted=planted)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class Broken:
    """The engine with its output changed where it is produced."""

    def __init__(self, engine, change):
        self.engine, self.change = engine, change

    def __call__(self, images, **kw):
        return self.change(self.engine(images, **kw).clone())


def half_left_out(out):
    b = out.shape[0]
    out[b // 2:] = out[:b // 2].mean(dim=0)
    return out


def one_answer_altered(out):
    """One robot's action negated where the engine produces it."""
    out[0] = -out[0]
    return out


@pytest.mark.parametrize("which", ["deep", "chunk"])
def test_sound_run_is_correct(tmp_path, capsys, which):
    result = run(tmp_path, capsys, which=which)
    assert result["correct"] is True
    assert list(result)[-1] == "checked"
    assert result["checked"]["actions_rms_rel"]["value"] < 1e-4


@pytest.mark.parametrize("change", [half_left_out, one_answer_altered])
def test_broken_answers_fail(tmp_path, capsys, change):
    def plant(work):
        work.engine = Broken(work.engine, change)
    assert run(tmp_path, capsys, plant)["correct"] is False


def test_state_left_unchanged_fails(tmp_path, capsys, monkeypatch):
    """Every step of the reverse loop returns its state unchanged."""
    monkeypatch.setattr(head, "ddpm_sampler_op",
                        lambda noisy, *a, **k: noisy.clone())
    assert run(tmp_path, capsys)["correct"] is False


@pytest.mark.parametrize("which", ["deep", "chunk"])
@pytest.mark.parametrize("fault", ["block_dropped", "mask_off"])
def test_stack_faults_fail(tmp_path, capsys, which, fault):
    """A fault planted in the transformer stack: a block dropped, the
    attention mask left out.  (Every merge reversed moves a tiny cell's
    actions by about 2%, under the limit: ToMe's weighted average keeps
    the tokens' sum, which the readouts mostly read; its readings at the
    cells' size are in ``PERF.md``.)"""
    with planted(fault) as hook:
        assert run(tmp_path, capsys, hook, which)["correct"] is False


@pytest.mark.parametrize("which", ["deep", "chunk"])
def test_control_fails(tmp_path, which):
    """The reference computed with float8 e4m3 operands, on the ticks a
    run samples, reads above the limit."""
    bench(tmp_path, which)
    work = Workload(json.loads((tmp_path / "configs" / "tiny.json")
                               .read_text()),
                    json.loads((tmp_path / "traffic" / "t.json").read_text()),
                    SEED, "cpu")
    work.setup()
    work.window(0.3)
    calls = work.sample()
    want = work.reference_actions(calls)
    control = work.reference_actions(calls, operands=torch.float8_e4m3fn)
    got = torch.cat([work.actions[i] for i in calls])
    assert work.compared(got, want)["actions_rms_rel"] < 1e-4
    assert work.compared(control, want)["actions_rms_rel"] \
        > LIMITS["actions_rms_rel"]
