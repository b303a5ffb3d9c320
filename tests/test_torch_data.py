"""The port's record readers and host-to-device prefetch, on the CPU.

``RecordReader`` and ``EpisodeWindowSampler`` are the port's own copies of
the JAX package's (numpy only).  They read files written by the JAX
package's writers and yield the batches its readers yield, exactly;
``state()`` / ``restore_state()`` resume at the batch the JAX readers
resume at.  ``prefetch_to_device`` on the CPU yields the same batches in
order.  ``MetricLogger`` writes the JAX logger's JSON lines.
"""

import io
import json

import numpy as np
import pytest
import torch

from multi_modal_transformers_tokenmerge_torch.utils import data as tdata
from multi_modal_transformers_tokenmerge_torch.utils import logging as tlog
from multi_modal_transformers_tokenmerge_torch.utils import episodes as teps
from multi_modal_transformers_tokenmerge_torch.utils import recordio as trec
from multi_modal_transformers_tokenmerge_tpu.utils import episodes as jeps
from multi_modal_transformers_tokenmerge_tpu.utils import logging as jlog
from multi_modal_transformers_tokenmerge_tpu.utils import recordio as jrec


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
             "action": rng.normal(size=(3,)).astype(np.float32),
             "text_ids": rng.integers(0, 50, (5,), dtype=np.int32)}
            for _ in range(n)]


def _episodes(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, (t, 4, 4, 3), dtype=np.uint8),
             "actions": rng.normal(size=(t, 2)).astype(np.float32),
             "text_ids": rng.integers(0, 50, (6,), dtype=np.int32)}
            for t in lengths]


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle_seed", [None, 7])
@pytest.mark.parametrize("shards", [(0, 1), (1, 2)])
def test_record_reader_reads_jax_files(tmp_path, shuffle_seed, shards):
    """Files written by the JAX writer (two of them, read as one index
    space): the port's reader yields the JAX reader's batches through
    three epochs, and a port writer's file equals the JAX writer's."""
    paths = [str(tmp_path / f"part{i}.rec") for i in range(2)]
    for i, p in enumerate(paths):
        assert jrec.write_records(p, _examples(11, seed=i)) == 11
    shard_id, num_shards = shards
    kw = dict(batch_size=3, shuffle_seed=shuffle_seed, shard_id=shard_id,
              num_shards=num_shards)
    ours, theirs = trec.RecordReader(paths, **kw), jrec.RecordReader(paths,
                                                                     **kw)
    assert ours.batches_per_epoch == theirs.batches_per_epoch
    for _ in range(3 * ours.batches_per_epoch + 1):
        _assert_batches_equal(next(ours), next(theirs))
    own = str(tmp_path / "own.rec")
    trec.write_records(own, _examples(11, seed=0))
    with open(own, "rb") as f, open(paths[0], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("consumed", [2, 5, 9])
def test_record_reader_resumes_where_jax_resumes(tmp_path, consumed):
    path = str(tmp_path / "data.rec")
    jrec.write_records(path, _examples(13))
    ours = trec.RecordReader(path, 4, shuffle_seed=3)
    for _ in range(consumed):
        next(ours)
    assert ours.state() == {"consumed": consumed}
    resumed = trec.RecordReader(path, 4, shuffle_seed=3).restore_state(
        ours.state())
    reference = jrec.RecordReader(path, 4, shuffle_seed=3).restore_state(
        {"consumed": consumed})
    for _ in range(4):
        want = next(ours)
        _assert_batches_equal(next(resumed), want)
        _assert_batches_equal(next(reference), want)
    with pytest.raises(ValueError, match="fresh reader"):
        ours.restore_state({"consumed": 1})


@pytest.mark.parametrize("frames", [1, 2, 3])
def test_episode_sampler_matches_jax(tmp_path, frames):
    """Windows over episodes written by the JAX writer, history clamped at
    each episode's start: the JAX sampler's batches, and the same resume."""
    path = str(tmp_path / "eps.rec")
    assert jeps.write_episodes(path, _episodes([3, 1, 5, 4])) == 13
    kw = dict(batch_size=4, frames=frames, shuffle_seed=2)
    ours = teps.EpisodeWindowSampler(path, **kw)
    theirs = jeps.EpisodeWindowSampler(path, **kw)
    for _ in range(7):
        batch = next(ours)
        assert batch["images"].shape == (4, frames, 4, 4, 3)
        _assert_batches_equal(batch, next(theirs))
    resumed = teps.EpisodeWindowSampler(path, **kw).restore_state(
        ours.state())
    reference = jeps.EpisodeWindowSampler(path, **kw).restore_state(
        theirs.state())
    for _ in range(3):
        want = next(reference)
        _assert_batches_equal(next(resumed), want)
        _assert_batches_equal(next(ours), want)


@pytest.mark.parametrize("size", [0, 1, 3])
def test_prefetch_to_device_on_the_cpu_keeps_order(size):
    batches = [(np.full((2, 3), i, np.float32),
                {"ids": np.arange(4, dtype=np.int32) + i})
               for i in range(6)]
    out = list(tdata.prefetch_to_device(iter(batches), size=size,
                                        device="cpu"))
    assert len(out) == len(batches)
    for (x, d), (want_x, want_d) in zip(out, batches):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), want_x)
        np.testing.assert_array_equal(d["ids"].numpy(), want_d["ids"])


def test_metric_logger_writes_the_jax_loggers_lines(tmp_path):
    """fit's logger: one JSON object a log, to a stream or appended to a
    file, with the JAX package's keys and values (the time aside)."""
    metrics = {"loss": torch.tensor(0.25), "steps_per_sec": 3.5}
    lines = {}
    for name, mod in (("torch", tlog), ("jax", jlog)):
        stream = io.StringIO()
        logger = mod.make_logger(stream=stream)
        logger.log(metrics, step=7)
        logger.close()
        path = tmp_path / f"{name}.jsonl"
        to_file = mod.make_logger(jsonl_path=str(path))
        to_file.log(metrics, step=8)
        to_file.close()
        lines[name] = [json.loads(stream.getvalue()),
                       json.loads(path.read_text())]
    for got, want in zip(*lines.values()):
        assert got.pop("time") > 0 and want.pop("time") > 0
        assert got == want
    assert lines["torch"][0] == {"loss": 0.25, "steps_per_sec": 3.5,
                                 "step": 7}
