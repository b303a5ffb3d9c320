"""The port's YAML configs, loader and CLI against the JAX package's, on
the CPU.  Exact: every YAML file of the port parses to the JAX file's
tree; every config and override gives equal ``dataclasses.asdict`` in both
packages; bad input raises the same exception type in both; every CLI
command prints the JAX CLI's JSON and returns its exit code (``info``:
all but its backend and devices)."""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import yaml

from multi_modal_transformers_tokenmerge_torch import __main__ as tcli
from multi_modal_transformers_tokenmerge_torch.core import config as tconfig
from multi_modal_transformers_tokenmerge_torch.core import yaml_loader as tyl
from multi_modal_transformers_tokenmerge_torch.models import presets as tpre
from multi_modal_transformers_tokenmerge_tpu import __main__ as jcli
from multi_modal_transformers_tokenmerge_tpu.core import config as jconfig
from multi_modal_transformers_tokenmerge_tpu.core import yaml_loader as jyl

ROOTS = ("octo_base", "octo_base_tome", "octo_deep")
# every override of tests/test_config.py, and the ones the chip run uses
OVERRIDES = (
    (),
    ("transformer.num_blocks=4", "dtype=bfloat16"),
    ("heads=continuous", "text=embed"),
    ("images.resnet.num_blocks=3",),
    ("transformer.num_blocks=2",),
    ("dtype=bfloat16",),
    ("dtype=bfloat16", "heads.diffusion.num_blocks=3",
     "transformer.mlp_activation=gelu"),
    ("heads=diffusion", "images.resnet.group_norm_epsilon=1.0e-5",
     "heads.diffusion.ddim_steps=8", "transformer.final_norm=true"),
    ("text=t5_base", "transformer=tome", "heads=categorical",
     "compression_sequence='[TaskDescriptionPrefix{0}] "
     "[Image{2};Readout{0}]*2'"),
)


def _yaml_files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*.yaml"))


# the port's own presets, which the JAX package does not have
PORT_ONLY = (Path("octo_moonlight.yaml"), Path("transformer/moonlight.yaml"))


def test_yaml_files_are_copies():
    """Same files, same trees (comments may differ), besides the port's own
    presets."""
    assert _yaml_files(tyl.CONFIG_DIR) == sorted(
        _yaml_files(jyl.CONFIG_DIR) + list(PORT_ONLY))
    assert len(_yaml_files(jyl.CONFIG_DIR)) == 13
    for rel in _yaml_files(jyl.CONFIG_DIR):
        with open(Path(tyl.CONFIG_DIR) / rel) as a, \
                open(Path(jyl.CONFIG_DIR) / rel) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b), rel


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o)
                         or "none")
@pytest.mark.parametrize("name", ROOTS)
def test_load_config_matches_jax(name, overrides):
    got = tyl.load_config(name, list(overrides))
    want = jyl.load_config(name, list(overrides))
    assert isinstance(got, tconfig.OctoConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert hash(got) == hash(tyl.load_config(name, list(overrides)))


@pytest.mark.parametrize("name", ["octo_base", "octo_deep", "octo_moonlight"])
def test_yaml_equals_preset(name):
    assert tyl.load_config(name) == tpre.PRESETS[name]()
    assert tyl.load_config(name, ["dtype=bfloat16"]) == tpre.PRESETS[name](
        dtype="bfloat16")


@pytest.mark.parametrize("overrides", [
    ["heads.bogus_head.x=1"],               # unknown head: ValueError
    ["nonsense_group=embed"],               # unknown field: KeyError
    ["transformer.typo=2"],                 # unknown field: KeyError
    ["no_equals_sign"],                     # ValueError
    ["transformer.num_blocks=abc"],         # TypeError
    ["dtype=3"],                            # TypeError
    ["text.frozen=1"],                      # TypeError (bool)
    ["heads=no_such_file"],                 # FileNotFoundError
    ["transformer.attention.num_heads.x=1"],  # through a non-dict
])
def test_bad_input_raises_like_jax(overrides):
    with pytest.raises(Exception) as want:
        jyl.load_config("octo_base", overrides)
    with pytest.raises(Exception) as got:
        tyl.load_config("octo_base", overrides)
    assert type(got.value) is type(want.value)


def test_unknown_config_and_field_raise_like_jax():
    for fn in (jyl.load_config, tyl.load_config):
        with pytest.raises(FileNotFoundError):
            fn("no_such_config")
    with pytest.raises(KeyError):
        tyl.config_from_dict(tconfig.TransformerConfig,
                             {"num_blocks": 1, "typo": 2})
    with pytest.raises(KeyError):
        jyl.config_from_dict(jconfig.TransformerConfig,
                             {"num_blocks": 1, "typo": 2})


def _write_tree(root, text_group, root_yaml):
    for sub in ("text", "images", "transformer", "heads"):
        os.makedirs(root / sub, exist_ok=True)
    (root / "root.yaml").write_text(root_yaml)
    (root / "text" / "a.yaml").write_text(text_group)
    (root / "heads" / "h.yaml").write_text(
        "continuous:\n  action_space_dim: 4\n")


@pytest.mark.parametrize("text_group,root_yaml,error", [
    ("kind: embed\nvocab_size: 64\nembedding_dim: ${token_embedding_dim}\n",
     "defaults:\n  text: a\n  heads: h\ndtype: bfloat16\n"
     "token_embedding_dim: 32\n", None),
    # a chain: text.embedding_dim -> token_embedding_dim -> text.max_length
    ("kind: embed\nmax_length: 8\nembedding_dim: ${token_embedding_dim}\n",
     "defaults:\n  text: a\n  heads: h\ndtype: ${param_dtype}\n"
     "param_dtype: bfloat16\ntoken_embedding_dim: ${text.max_length}\n",
     None),
    ("kind: embed\n",
     "defaults:\n  text: a\n  heads: h\ntoken_embedding_dim: ${nope.x}\n",
     KeyError),
    ("kind: embed\n",
     "defaults:\n  text: a\n  heads: h\ndtype: ${param_dtype}\n"
     "param_dtype: ${dtype}\n", ValueError),
], ids=["plain", "chain", "missing", "cycle"])
def test_interpolation_matches_jax(tmp_path, text_group, root_yaml, error):
    """${...} interpolation, chains, the missing-key and cycle errors."""
    _write_tree(tmp_path, text_group, root_yaml)
    if error is not None:
        for fn in (jyl.load_config, tyl.load_config):
            with pytest.raises(error):
                fn("root", config_dir=str(tmp_path))
        return
    got = tyl.load_config("root", config_dir=str(tmp_path))
    want = jyl.load_config("root", config_dir=str(tmp_path))
    assert got.dtype == "bfloat16"
    assert got.text.embedding_dim == got.token_embedding_dim in (32, 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_interpolation_resolves_inside_lists():
    tree = {"x": "${y}", "y": "${z}", "z": 7, "l": ["${x}", {"k": "${y}"}]}
    tyl._resolve_interpolations(tree)
    assert tree == {"x": 7, "y": 7, "z": 7, "l": [7, {"k": 7}]}


# -- the CLI ----------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def _rec_files(tmp_path):
    from multi_modal_transformers_tokenmerge_torch.utils import episodes
    from multi_modal_transformers_tokenmerge_torch.utils import recordio
    rng = np.random.default_rng(0)
    eps = [{"images": rng.integers(0, 256, (t, 4, 4, 3), dtype=np.uint8),
            "actions": rng.normal(size=(t, 2)).astype(np.float32),
            "text_ids": rng.integers(0, 50, (6,), dtype=np.int32)}
           for t in (3, 2)]
    ep = str(tmp_path / "episodes.rec")
    episodes.write_episodes(ep, eps)
    other = str(tmp_path / "other.rec")
    recordio.write_records(other, [{"x": np.zeros((2,), np.float32)}] * 4)
    return ep, other


@pytest.mark.parametrize("argv", [
    ("layout", "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"),
    ("layout", "[TaskDescriptionPrefix{16}] [Image{100};Readout{4}]*2",
     "[TaskDescriptionPrefix{0}] [Image{32};Readout{0}]*2"),
    ("config", "octo_base"),
    ("config", "octo_deep", "dtype=bfloat16", "heads=continuous"),
    ("config", "octo_base_tome", "transformer.mlp_activation=gelu"),
    ("data", "EP"), ("data", "EP", "EP"), ("data", "EP", "OTHER"),
    ("layout",), ("config",), ("data",), ("no_such_command",),
], ids=lambda a: "-".join(a)[:40])
def test_cli_matches_jax(tmp_path, capsys, argv):
    ep, other = _rec_files(tmp_path)
    argv = [{"EP": ep, "OTHER": other}.get(a, a) for a in argv]
    rc_t, out_t = _run(tcli.main, argv)
    rc_j, out_j = _run(jcli.main, argv)
    assert rc_t == rc_j
    assert out_t == out_j
    if rc_j == 0:
        json.loads(out_t)
    else:
        assert rc_j == 2
        err = capsys.readouterr().err
        assert err.count("usage") + err.count("unknown command") == 2


def test_cli_info(capsys):
    rc_t, out_t = _run(tcli.main, ["info"])
    rc_j, out_j = _run(jcli.main, ["info"])
    assert rc_t == rc_j == 0
    got, want = json.loads(out_t), json.loads(out_j)
    assert sorted(got) == sorted(want)
    assert got["version"] == want["version"]
    # the port's own presets besides the JAX package's
    assert got["presets"] == sorted(want["presets"] + ["octo_moonlight"])
    assert got["backend"] == "cpu" and got["devices"] == ["cpu"]
    assert _run(tcli.main, [])[1] == out_t        # 'info' is the default


def test_top_level_exports():
    """The JAX package's top-level names that the port has."""
    import multi_modal_transformers_tokenmerge_torch as tp
    import multi_modal_transformers_tokenmerge_tpu as jp
    assert set(jp.__all__) <= set(tp.__all__)
    assert tp.__version__ == jp.__version__
    assert tp.load_config("octo_base") == tp.octo_base()
