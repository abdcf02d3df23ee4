"""edl_tpu_torch serving vs edl_tpu's: wire bytes, padding, interop.

- the port's msgpack codec is byte-identical to ``msgpack.packb(...,
  use_bin_type=True)`` on the payloads the protocol sends;
- ``TorchPredictBackend`` pads buckets exactly as ``JaxPredictBackend``;
- a JAX-package client talks to a port server and back;
- a JAX ``DistillReader`` streams soft labels from the port's NLP teacher
  that match the JAX distill_nlp teacher's with the same converted
  weights (fp32, 1e-5: summation order only; probabilities are < 1);
- admission shedding and ``CoalescingBackend`` over the port backend.
"""

import threading
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from edl_tpu.distill import DistillReader
from edl_tpu.distill import serving as jserving
from edl_tpu.models.transformer import TransformerLM as JaxLM
from edl_tpu_torch import convert
from edl_tpu_torch.distill import nlp_teacher
from edl_tpu_torch.distill import serving as tserving
from edl_tpu_torch.rpc import _msgpack, wire
from edl_tpu_torch.rpc.ndarray import encode_tree, encode_tree_zc
from edl_tpu_torch.utils.exceptions import EdlOverloadError


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """Compile this module's JAX code afresh: another test file in the same
    worker may have armed JAX's persistent compilation cache with a key
    function (``edl_tpu.train.aot.enable_portable_cache_keys``) that this
    JAX version cannot call."""
    from jax._src import compilation_cache

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    compilation_cache.reset_cache()


PAYLOADS = [
    pytest.param({"i": 1, "m": "ping"}, id="ping"),
    pytest.param({"i": 7, "ok": True, "qd": 0, "ew": 1.25}, id="ok"),
    pytest.param(
        {"i": 2, "ok": False, "qd": 3, "ew": 12.5,
         "err": {"etype": "EdlOverloadError", "detail": "shed (queue)"}},
        id="shed",
    ),
    pytest.param(
        encode_tree_zc({"i": 3, "m": "predict", "dl": 250.0,
                        "feeds": {"tokens": np.zeros((3, 64), np.int32)}})[0],
        id="predict-zc",
    ),
    pytest.param(
        encode_tree({"fetchs": {"soft": np.arange(6, dtype=np.float32)}}),
        id="ndarray-inline",
    ),
    pytest.param(
        {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                  2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                  -2**31, -2**31 - 1, -2**63],
         "floats": [0.0, -1.5, 1e300, float("inf")],
         "nil": None, "t": True, "f": False},
        id="scalars",
    ),
    pytest.param(
        {"s": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
         "b": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
         "tc": ["0123456789abcdef", "fedcba98"]},
        id="lengths",
    ),
    pytest.param(
        {"arr": list(range(16)), "map": {str(i): i for i in range(16)},
         "nested": [[], {}, [[1, {"k": [None]}]]], 5: "int-key"},
        id="containers",
    ),
]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_msgpack_codec_is_byte_identical(payload):
    want = msgpack.packb(payload, use_bin_type=True)
    got = _msgpack.packb(payload)
    assert got == want
    decoded = _msgpack.unpackb(got)
    assert decoded == msgpack.unpackb(want, raw=False, strict_map_key=False)


def test_msgpack_rejects_malformed_bodies():
    body = _msgpack.packb({"i": 1})
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(body + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(body[:-1])
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})


def test_frames_are_byte_identical_to_jax_package():
    from edl_tpu.rpc import wire as jwire

    payload = {"i": 9, "m": "predict", "feeds": {"a": 1}}
    assert wire.pack_frame(payload) == jwire.pack_frame(payload)
    enc, atts = encode_tree_zc({"x": np.ones((2, 3), np.float32)})
    ours = b"".join(bytes(b) for b in wire.pack_frame_buffers(enc, atts))
    theirs = b"".join(bytes(b) for b in jwire.pack_frame_buffers(enc, atts))
    assert ours == theirs


def _probe_apply_jax(feeds):
    x = feeds["x"]
    # every row carries the sum over the PADDED batch: reveals bucket + pad
    return {"x2": x * 2.0, "padsum": jnp.broadcast_to(x.sum(0), x.shape)}


def _probe_apply_torch(feeds):
    x = feeds["x"]
    return {"x2": x * 2.0, "padsum": x.sum(0).expand(x.shape)}


@pytest.mark.parametrize("n", [1, 3, 5])
def test_bucket_padding_matches_jax_backend(n):
    x = np.random.RandomState(n).randn(n, 4).astype(np.float32)
    jb = jserving.JaxPredictBackend(_probe_apply_jax, max_batch=8)
    tb = tserving.TorchPredictBackend(_probe_apply_torch, max_batch=8,
                                      device="cpu")
    want, got = jb({"x": x}), tb({"x": x})
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32 and got[key].shape == (n, 4)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    bucket = 1 << (n - 1).bit_length()
    padded = np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)])
    np.testing.assert_allclose(got["padsum"][0], padded.sum(0), rtol=1e-6)


def test_backend_dispatch_fetch_split_and_empty_batch():
    tb = tserving.TorchPredictBackend(_probe_apply_torch, device="cpu")
    handle = tb.dispatch({"x": np.ones((3, 2), np.float32)})
    out = tb.fetch(handle)
    np.testing.assert_array_equal(out["x2"], np.full((3, 2), 2.0, np.float32))
    assert tb({"x": np.zeros((0, 2), np.float32)}) == {}


@pytest.mark.parametrize("direction", ["jax-client", "port-client"])
def test_cross_package_predict(direction):
    feeds = {"img": np.arange(12, dtype=np.float32).reshape(3, 4)}
    if direction == "jax-client":
        server = tserving.PredictServer(
            tserving.EchoPredictBackend(), host="127.0.0.1"
        ).start()
        client_cls = jserving.PredictClient
    else:
        server = jserving.PredictServer(
            jserving.EchoPredictBackend(), host="127.0.0.1"
        ).start()
        client_cls = tserving.PredictClient
    client = client_cls("127.0.0.1:%d" % server.port)
    try:
        out = client.predict(feeds)
        np.testing.assert_allclose(out["echo_img"], feeds["img"].sum(axis=1))
        assert client.ping()
    finally:
        client.close()
        server.stop()


def test_jax_reader_streams_port_teacher_soft_labels():
    small = nlp_teacher.CONFIGS["small"]["model"]
    kwargs = {k: v for k, v in small.items() if k != "dtype"}
    jmodel = JaxLM(dtype=jnp.float32, **kwargs)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)

    @jax.jit
    def jax_teacher(tokens):  # examples/distill_nlp.py run_teacher's apply
        return jax.nn.softmax(jmodel.apply({"params": params}, tokens), -1)

    model = nlp_teacher.build_teacher("small", device="cpu")
    convert.load_params(model, params)
    backend = tserving.TorchPredictBackend(
        nlp_teacher.make_apply(model), device="cpu"
    )
    server = tserving.PredictServer(backend, host="127.0.0.1").start()
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 1024, (n, 64)).astype(np.int32) for n in (4, 3)]
    reader = DistillReader(
        feeds=["tokens"], fetchs=["soft_label"], teacher_batch_size=4
    )
    reader.set_fixed_teacher("127.0.0.1:%d" % server.port)
    reader.set_batch_generator(lambda: iter([(b,) for b in batches]))
    try:
        got = list(reader())
    finally:
        reader.stop()
        server.stop()
    assert len(got) == 2
    for (tokens, soft), sent in zip(got, batches):
        np.testing.assert_array_equal(tokens, sent)
        assert soft.shape == (sent.shape[0], 64, 1024)
        want = np.asarray(jax_teacher(jnp.asarray(sent)))
        np.testing.assert_allclose(soft, want, atol=1e-5)


class _SlowTorchBackend(tserving.TorchPredictBackend):
    def __init__(self, service_s):
        super().__init__(_probe_apply_torch, device="cpu")
        self._service_s = service_s

    def dispatch(self, feeds):
        time.sleep(self._service_s)
        return super().dispatch(feeds)


def test_admission_sheds_past_queue_limit():
    server = tserving.PredictServer(
        _SlowTorchBackend(0.2), host="127.0.0.1", queue_limit=1, slo_ms=0
    ).start()
    clients = [tserving.PredictClient("127.0.0.1:%d" % server.port)
               for _ in range(3)]
    sheds, oks = [], []

    def call(c):
        try:
            oks.append(c.predict({"x": np.ones((2, 4), np.float32)}))
        except EdlOverloadError as exc:
            sheds.append(exc)

    try:
        threads = [threading.Thread(target=call, args=(c,)) for c in clients]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        for c in clients:
            c.close()
        server.stop()
    assert oks and sheds
    assert sheds[0].qdepth >= 1


def test_doomed_deadline_is_shed_at_admission():
    server = tserving.PredictServer(
        _SlowTorchBackend(0.1), host="127.0.0.1", queue_limit=8, slo_ms=0
    ).start()
    client = tserving.PredictClient("127.0.0.1:%d" % server.port)
    try:
        client.predict({"x": np.ones((2, 4), np.float32)})
        with pytest.raises(EdlOverloadError):
            client.predict({"x": np.ones((2, 4), np.float32)},
                           deadline_s=0.005)
    finally:
        client.close()
        server.stop()


def test_coalescing_over_torch_backend():
    calls = []

    def apply(feeds):
        calls.append(feeds["x"].shape[0])
        return {"y": feeds["x"] * 3.0}

    backend = tserving.CoalescingBackend(
        tserving.TorchPredictBackend(apply, device="cpu"), max_wait_ms=50.0
    )
    results = {}

    def call(i):
        results[i] = backend({"x": np.full((i + 1, 2), i, np.float32)})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        backend.close()
    for i in range(4):
        np.testing.assert_array_equal(
            results[i]["y"], np.full((i + 1, 2), 3.0 * i, np.float32)
        )
    assert backend.requests_served == 4
    assert backend.batches_run < 4  # at least two requests shared a call
    assert sum(calls) >= 10  # padded cohorts cover every row
