"""The plain reference against the program's CPU path at tiny sizes (the
program in float32 runs its kernels' plain versions there), from the same
drawn weights and inputs."""

import torch
import pytest

from multi_modal_transformers_tokenmerge_torch import Octo, PolicyEngine
from multi_modal_transformers_tokenmerge_torch.core.yaml_loader import \
    load_config
from portbench import weights as W
from portbench.reference.octo import OctoReference, exact_float32
from portbench.tests.tiny import PRESETS, model_of


@pytest.mark.parametrize("which", sorted(PRESETS))
def test_reference_follows_the_program(which):
    preset, overrides = PRESETS[which]
    model = model_of(preset, overrides)
    net = Octo(load_config(preset, overrides), device="cpu", seed=None)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    net.load_state_dict(W.draw(shapes, 2**33 + 5, "cpu", model), assign=True)
    b = 3
    engine = PolicyEngine(net, batch_size=b, seed=11)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, 100, (16,), generator=g)
    images = torch.randint(0, 256, (b, 2, 280, 280, 3), dtype=torch.uint8,
                           generator=g)
    engine.set_instruction(ids.numpy())
    engine.compile((16,), (2, 280, 280, 3))
    got = engine(images)
    ref = OctoReference(model, W.draw(shapes, 2**33 + 5, "cpu", model), "cpu")
    noise = torch.Generator().manual_seed(11)
    c = model["heads"]["diffusion"]
    noisy = torch.randn((b, c["action_space_dim"]), generator=noise)
    per_step = torch.randn((c["diffusion_steps"], b, c["action_space_dim"]),
                           generator=noise)
    with exact_float32():
        want = ref.policy(ref.encode_text(ids[None]).expand(b, -1, -1),
                          images, noisy, per_step)
    assert (got - want).abs().max() <= 1e-4 * (1 + want.abs().max())


def test_draw_is_the_seeds():
    model = model_of(*PRESETS["chunk"])
    shapes = {"a.bias": (4,), "t.weight": (3, 5)}
    shapes.update({"d.denoiser.noisy_proj.weight": (6, 2),
                   "d.denoiser.first_out.weight": (2, 6)})
    one = W.draw(shapes, 123, "cpu", model)
    two = W.draw(shapes, 123, "cpu", model)
    other = W.draw(shapes, 124, "cpu", model)
    for k in shapes:
        assert torch.equal(one[k], two[k])
        assert not torch.equal(one[k], other[k])
    wn = one["d.denoiser.noisy_proj.weight"]
    assert torch.allclose(one["d.denoiser.first_out.weight"],
                          wn.T * 2 * 2 / wn.square().sum())
