"""The port's micro-batching PolicyServer against the JAX package's, on
the CPU: the behaviours of the JAX server tests
(tests/test_optim_server.py), each held on both servers with the same
requests.  The engines serve the deterministic continuous head of
octo_micro with the JAX weights carried across by ``convert.from_flax``.

Tolerance: float32 actions through the whole micro model, 1e-4 (the JAX
server tests' own), between the port and the JAX package; within one
package a server row equals its direct engine call to 1e-6."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_configs import octo_micro
from multi_modal_transformers_tokenmerge_torch import convert
from multi_modal_transformers_tokenmerge_torch.models.octo import Octo as TOcto
from multi_modal_transformers_tokenmerge_torch.serve.policy import (
    PolicyEngine as TEngine)
from multi_modal_transformers_tokenmerge_torch.serve.server import (
    PolicyServer as TServer)
from multi_modal_transformers_tokenmerge_tpu.models.octo import Octo as JOcto
from multi_modal_transformers_tokenmerge_tpu.serve.policy import (
    PolicyEngine as JEngine)
from multi_modal_transformers_tokenmerge_tpu.serve.server import (
    PolicyServer as JServer)
from torch_parity import to_torch_config

TOL = 1e-4
BATCH = 4
TEXT = np.ones((4,), np.int32)


@pytest.fixture(scope="module")
def models():
    cfg = octo_micro()
    jm = JOcto(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    v = jm.init({"params": keys[0], "patch_encoding": keys[1],
                 "dropout": keys[2], "diffusion": keys[3]},
                jnp.ones((BATCH, 4), jnp.int32), jnp.ones((BATCH, 64, 64, 3)))
    tc = to_torch_config(cfg)
    tm = TOcto(tc, device="cpu", seed=None)
    tm.load_state_dict(convert.from_flax(
        jax.tree.map(np.asarray, v["params"]), tc))
    return jm, v, tm


def _engines(models, instruction=True, compiled=False):
    """(JAX engine, port engine) of the continuous head at BATCH."""
    jm, v, tm = models
    je = JEngine(jm, v, head="continuous", batch_size=BATCH)
    te = TEngine(tm, head="continuous", batch_size=BATCH)
    if compiled:
        te.compile((4,), (64, 64, 3))
    if instruction:
        je.set_instruction(jnp.asarray(TEXT))
        te.set_instruction(TEXT)
    return je, te


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
            for _ in range(n)]


def _concurrently(server, images, instructions=None):
    results = [None] * len(images)
    errors = [None] * len(images)

    def call(i):
        try:
            results[i] = server.predict(
                images[i], None if instructions is None else instructions[i])
        except Exception as e:  # noqa: BLE001 - recorded for the test
            errors[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(images))]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    return results, errors


@pytest.mark.parametrize("compiled", [False, True])
def test_single_and_burst_match_jax(models, compiled):
    """One request, then a burst of six concurrent ones coalesced into
    batches: each row equals the JAX server's for the same image."""
    je, te = _engines(models, compiled=compiled)
    imgs = _images(6, seed=0)
    with JServer(je, max_wait_ms=1.0) as js, \
            TServer(te, max_wait_ms=1.0) as ts:
        a, b = js.predict(imgs[0]), ts.predict(imgs[0])
        assert a.shape == b.shape == (1, 4)
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
        want, _ = _concurrently(js, imgs)
        got, errors = _concurrently(ts, imgs)
    assert errors == [None] * 6
    for g, w in zip(got, want):
        assert g is not None and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_server_row_equals_direct_engine_call(models):
    """A server row is the engine's own answer for that image (the tail
    padded with the last request changes no row)."""
    _, te = _engines(models)
    imgs = _images(3, seed=1)
    with TServer(te, max_wait_ms=50.0) as ts:
        got, _ = _concurrently(ts, imgs)
    direct = te(np.stack(imgs + [imgs[-1]])).numpy()
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, direct[i], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_tail_padded_with_last_request(models, impl):
    """A partial batch reaches the engine padded with its last request."""
    je, te = _engines(models)
    engine, server_cls = (je, JServer) if impl == "jax" else (te, TServer)
    seen = []

    class Recording:
        def __init__(self, eng):
            self.eng = eng

        def __getattr__(self, name):
            return getattr(self.eng, name)

        def __call__(self, images, **kw):
            seen.append(np.asarray(images))
            return self.eng(images, **kw)

    imgs = _images(2, seed=2)
    with server_cls(Recording(engine), max_wait_ms=200.0) as s:
        _concurrently(s, imgs)
    batch = seen[-1]
    assert batch.shape[0] == BATCH
    np.testing.assert_array_equal(batch[2], batch[1])
    np.testing.assert_array_equal(batch[3], batch[1])


def test_errors_propagate_like_jax(models):
    """A bad image shape raises to its caller on both servers."""
    je, te = _engines(models)
    with JServer(je, max_wait_ms=1.0) as js, \
            TServer(te, max_wait_ms=1.0) as ts:
        for s in (js, ts):
            with pytest.raises(Exception):
                s.predict(np.ones((3, 3), np.float32))


def test_one_error_fails_every_waiter_of_its_batch(models):
    """A bad request coalesced with good ones fails the whole batch, on
    both servers."""
    je, te = _engines(models)
    imgs = _images(2, seed=3) + [np.ones((3, 3), np.float32)]
    for server_cls, eng in ((JServer, je), (TServer, te)):
        with server_cls(eng, max_wait_ms=500.0) as s:
            results, errors = _concurrently(s, imgs)
        assert results == [None] * 3
        assert all(e is not None for e in errors)
        assert len({id(e) for e in errors}) == 1       # one shared error


def test_encode_instruction_cache_and_equivalence(models):
    jm, v, _ = models
    je, te = _engines(models)
    ids = np.array([1, 2, 3, 2], np.int32)
    e1, e2 = te.encode_instruction(ids), te.encode_instruction(ids)
    assert e1 is e2                                      # memoized
    with torch.no_grad():
        ref = te.model.encode_text(torch.from_numpy(ids[None]).long())[0]
    torch.testing.assert_close(e1, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(e1.numpy(), np.asarray(
        je.encode_instruction(jnp.asarray(ids))), rtol=TOL, atol=TOL)
    for eng in (je, te):
        with pytest.raises(ValueError):
            eng.encode_instruction(np.ones((2, 4), np.int32))


def test_mixed_instruction_batch_matches_tokens_path(models):
    je, te = _engines(models)
    ids_a = np.array([1, 2, 3, 4], np.int32)
    ids_b = np.array([5, 6, 7, 8], np.int32)
    images = np.stack(_images(4, seed=4))
    emb = torch.stack([te.encode_instruction(i)
                       for i in (ids_a, ids_b, ids_a, ids_b)])
    tokens = np.stack([ids_a, ids_b, ids_a, ids_b])
    mixed = te(images, text_embeddings=emb)
    direct = te(images, text_tokens=tokens)
    torch.testing.assert_close(mixed, direct, rtol=1e-5, atol=1e-5)
    ref = je(jnp.asarray(images), text_tokens=jnp.asarray(tokens))
    np.testing.assert_allclose(mixed.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError):
        te(images, text_tokens=tokens, text_embeddings=emb)


def test_rejects_missing_instruction_early(models):
    """With no engine default, a request without instruction is rejected
    in predict() itself while a valid request is in flight, on both
    servers; the valid one is served."""
    je, te = _engines(models, instruction=False)
    ids = np.asarray([1, 2, 3, 4], np.int32)
    img = np.ones((64, 64, 3), np.float32)
    got = {}
    for name, server_cls, eng in (("jax", JServer, je),
                                  ("port", TServer, te)):
        with server_cls(eng, max_wait_ms=20.0) as s:
            t = threading.Thread(target=lambda: got.__setitem__(
                name, s.predict(img, instruction=ids)))
            t.start()
            with pytest.raises(ValueError, match="no set_instruction default"):
                s.predict(img)
            t.join(timeout=60)
    assert np.isfinite(got["port"]).all()
    np.testing.assert_allclose(got["port"], got["jax"], rtol=TOL, atol=TOL)


def test_predict_after_stop_raises(models):
    je, te = _engines(models)
    img = np.ones((64, 64, 3), np.float32)
    for server_cls, eng in ((JServer, je), (TServer, te)):
        server = server_cls(eng, max_wait_ms=1.0).start()
        assert server.predict(img).shape == (1, 4)
        server.stop()
        with pytest.raises(RuntimeError, match="not running"):
            server.predict(img)


def test_stop_fails_pending_waiters(models):
    """stop() while a request waits behind a running batch: the running
    one is served, the pending one fails at once with 'stopped'."""
    je, te = _engines(models)
    imgs = _images(2, seed=5)
    for server_cls, eng in ((JServer, je), (TServer, te)):
        gate, entered = threading.Event(), threading.Event()

        class Gated:
            def __getattr__(self, name):
                return getattr(eng, name)

            def __call__(self, images, **kw):
                entered.set()
                gate.wait(30)
                return eng(images, **kw)

        server = server_cls(Gated(), max_wait_ms=0.0).start()
        out = {}

        def call(i):
            try:
                out[i] = server.predict(imgs[i])
            except RuntimeError as e:
                out[i] = e

        first = threading.Thread(target=call, args=(0,))
        first.start()
        assert entered.wait(30)
        second = threading.Thread(target=call, args=(1,))
        second.start()
        deadline = time.monotonic() + 30
        while server._requests.qsize() == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert server._requests.qsize() == 1
        threading.Timer(0.2, gate.set).start()
        server.stop()
        first.join(30)
        second.join(30)
        assert isinstance(out[0], np.ndarray)
        assert isinstance(out[1], RuntimeError)
        assert "stopped" in str(out[1])


def test_mixed_instructions_match_jax(models):
    """Three concurrent requests with their own instructions: each equals
    the JAX engine's answer for that instruction and image."""
    je, te = _engines(models)
    ids = [np.asarray([9 + i, 1, 2, 3], np.int32) for i in range(3)]
    imgs = _images(3, seed=6)
    want = []
    for instr, im in zip(ids, imgs):
        emb = jnp.broadcast_to(je.encode_instruction(jnp.asarray(instr)),
                               (BATCH, 4, 32))
        batch = jnp.broadcast_to(jnp.asarray(im), (BATCH, 64, 64, 3))
        want.append(np.asarray(je(batch, text_embeddings=emb))[0])
    with TServer(te, max_wait_ms=50.0) as ts:
        got, errors = _concurrently(ts, imgs, ids)
    assert errors == [None] * 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
