"""The dist wire (``bcfl_tpu_torch/dist/wire.py``) byte for byte against
``bcfl_tpu/dist/wire.py``: packed and streamed frames, every leaf kind
(bf16 included, which JAX writes as ``ml_dtypes``' ``"<V2"``), a codec
payload the port's encoder made, each package reading the other's frames,
and the truncated / bad-magic / deadline / CRC error contract."""

import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcfl_tpu.dist import wire as jw
from bcfl_tpu_torch.compression import CompressionConfig, encode_tree
from bcfl_tpu_torch.core import prng
from bcfl_tpu_torch.dist import wire as tw

pytestmark = pytest.mark.dist


def _bf16(values):
    return np.asarray(jnp.asarray(values, jnp.bfloat16))


def _leaves():
    """(name, port leaf, JAX leaf) of every kind the wire carries."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    i8 = rng.integers(-127, 128, (2, 7)).astype(np.int8)
    i32 = rng.integers(-2**31, 2**31 - 1, (4,)).astype(np.int32)
    b = rng.random((3, 2)) < 0.5
    f16 = rng.normal(size=(6,)).astype(np.float16)
    bf = rng.normal(size=(2, 3)).astype(np.float32)
    return [
        ("f32", torch.from_numpy(f32), f32),
        ("int8", torch.from_numpy(i8), i8),
        ("int32", torch.from_numpy(i32), i32),
        ("bool", torch.from_numpy(b), b),
        ("f16", torch.from_numpy(f16), f16),
        ("bf16", torch.from_numpy(bf).to(torch.bfloat16), _bf16(bf)),
        ("scalar", torch.tensor(2.5), np.float32(2.5)),
        ("empty", torch.zeros((0, 4)), np.zeros((0, 4), np.float32)),
        ("slash", torch.arange(4, dtype=torch.int32),
         np.arange(4, dtype=np.int32)),
    ]


LEAVES = _leaves()


def _pair(items):
    """Port and JAX trees over ``items`` (the slash leaf keyed as a codec
    payload keys its leaves, by path name)."""
    t, j = {}, {}
    for name, tl, jl in items:
        key = "layer/kernel" if name == "slash" else name
        t[key] = {"v": tl} if name == "slash" else tl
        j[key] = {"v": jl} if name == "slash" else jl
    return t, j


HEADER = {"type": "update", "base_version": 3, "n_ex": [5, 7],
          "digests": ["ab" * 32], "lineage": None}


@pytest.mark.parametrize("name", [n for n, _, _ in LEAVES])
def test_pack_frame_bytes_equal_jax_per_leaf_kind(name):
    t, j = _pair([x for x in LEAVES if x[0] == name])
    assert tw.pack_frame(HEADER, {"payload": t}) == jw.pack_frame(
        HEADER, {"payload": j})


#: every kind but bf16: JAX's STREAMED writer cannot send an ml_dtypes
#: bf16 leaf (``memoryview`` refuses its buffer format "E"), so a JAX
#: broadcast under param_dtype="bfloat16" raises; its in-memory
#: ``pack_frame`` is the reference for bf16 frames
STREAMABLE = [x for x in LEAVES if x[0] != "bf16"]


def test_jax_streamed_writer_refuses_bf16():
    _, j = _pair(LEAVES)
    with pytest.raises(ValueError, match="cannot include dtype"):
        jw.frame_prefix(HEADER, {"payload": j})


def test_whole_tree_and_multi_tree_frames_equal_jax():
    t, j = _pair(LEAVES)
    assert tw.pack_frame(HEADER, {"payload": t, "model": {"w": t["f32"]}}) \
        == jw.pack_frame(HEADER, {"payload": j, "model": {"w": j["f32"]}})
    assert tw.pack_frame({"type": "ping"}) == jw.pack_frame({"type": "ping"})
    # the prefix (length + CRC) of the streamed writer equals the packed
    # frame's, bf16 included
    assert tw.frame_prefix(HEADER, {"payload": t}) == jw.pack_frame(
        HEADER, {"payload": j})[:jw.PREFIX_LEN]
    ts, js = _pair(STREAMABLE)
    assert tw.frame_prefix(HEADER, {"payload": ts}) == jw.frame_prefix(
        HEADER, {"payload": js})


def _streamed(write, *args, **kw):
    """The bytes ``write(sock, *args)`` streams, read off a socketpair."""
    a, b = socket.socketpair()
    chunks = []

    def reader():
        while True:
            c = b.recv(1 << 16)
            if not c:
                return
            chunks.append(c)

    t = threading.Thread(target=reader)
    t.start()
    n = write(a, *args, **kw)
    a.close()
    t.join()
    b.close()
    out = b"".join(chunks)
    assert n == len(out)
    return out


def test_streamed_frame_equals_packed_and_jax():
    t, j = _pair(LEAVES)
    packed = jw.pack_frame(HEADER, {"payload": j})
    assert _streamed(tw.write_frame, HEADER, {"payload": t}) == packed
    ts, js = _pair(STREAMABLE)
    assert _streamed(tw.write_frame, HEADER, {"payload": ts}) == _streamed(
        jw.write_frame, HEADER, {"payload": js})


def _codec_payload(seed):
    rng = np.random.default_rng(seed)
    delta = {"layer_0/kernel": torch.from_numpy(
                 rng.normal(size=(2, 64, 48)).astype(np.float32) * 1e-3),
             "layer_0/bias": torch.from_numpy(
                 rng.normal(size=(2, 48)).astype(np.float32) * 1e-3),
             "emb": torch.from_numpy(
                 rng.normal(size=(2, 300, 16)).astype(np.float32) * 1e-3)}
    comp = CompressionConfig(kind="int8+topk")
    return encode_tree(comp, delta, prng.codec_uniforms(seed, 0))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_payload_frame_equals_jax(seed):
    payload = _codec_payload(seed)
    packed = jw.pack_frame(HEADER, {"payload": _numpy(payload)})
    assert tw.pack_frame(HEADER, {"payload": payload}) == packed
    assert _streamed(tw.write_frame, HEADER, {"payload": payload}) == packed


def _assert_tree_equal(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        if isinstance(j[k], dict):
            _assert_tree_equal(t[k], j[k])
            continue
        a, b = t[k], np.asarray(j[k])
        assert isinstance(a, torch.Tensor)
        if b.dtype.kind == "V" or b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            a = a.view(torch.int16).numpy().view(b.dtype)
        else:
            a = a.numpy()
            assert a.dtype == b.dtype, k
        assert a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_each_package_reads_the_others_frames():
    t, j = _pair(LEAVES)
    # the port reads JAX's frame: tensors, bf16 as torch.bfloat16
    hdr, trees = tw.unpack_frame(
        jw.pack_frame(HEADER, {"payload": j})[jw.PREFIX_LEN:])
    assert hdr == HEADER
    _assert_tree_equal(trees["payload"], jw.unpack_frame(
        jw.pack_frame(HEADER, {"payload": j})[jw.PREFIX_LEN:])[1]["payload"])
    assert trees["payload"]["bf16"].dtype == torch.bfloat16
    assert torch.equal(trees["payload"]["bf16"], t["bf16"])
    # a 0-d leaf crosses as shape [1] in both packages
    assert tuple(trees["payload"]["scalar"].shape) == (1,)
    # JAX reads the port's frame
    jhdr, jtrees = jw.unpack_frame(
        tw.pack_frame(HEADER, {"payload": t})[tw.PREFIX_LEN:])
    assert jhdr == HEADER
    _assert_tree_equal(tw.unpack_frame(
        tw.pack_frame(HEADER, {"payload": t})[tw.PREFIX_LEN:])[1]["payload"],
        jtrees["payload"])


def _serve(frame_bytes):
    """A listening socket that receives ``frame_bytes`` from a client
    thread; returns (accepted conn, cleanup)."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        if frame_bytes is not None:
            s.sendall(frame_bytes)
        time.sleep(0.5)
        s.close()

    th = threading.Thread(target=client)
    th.start()
    conn, _ = srv.accept()

    def done():
        th.join()
        conn.close()
        srv.close()
    return conn, done


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_read_frame_over_a_socket_across_packages(writer, reader):
    t, j = _pair(LEAVES)
    frame = (tw.pack_frame(HEADER, {"payload": t}) if writer == "port"
             else jw.pack_frame(HEADER, {"payload": j}))
    conn, done = _serve(frame)
    try:
        hdr, trees = (tw if reader == "port" else jw).read_frame(conn, 5.0)
    finally:
        done()
    assert hdr == HEADER
    if reader == "port":
        _assert_tree_equal(trees["payload"], jw.unpack_frame(
            frame[jw.PREFIX_LEN:])[1]["payload"])


def test_truncated_frame_raises_wire_error_in_both():
    t, j = _pair(LEAVES)
    frame = tw.pack_frame({"a": 1}, {"t": t})
    for mod in (tw, jw):
        with pytest.raises(mod.WireError):
            mod.unpack_frame(frame[mod.PREFIX_LEN:-3])


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_bad_magic_raises_wire_error(mod):
    m = tw if mod == "port" else jw
    frame = tw.pack_frame({"a": 1}, {"t": _pair(LEAVES)[0]})
    conn, done = _serve(b"XXXX" + frame[4:])
    try:
        with pytest.raises(m.WireError, match="magic"):
            m.read_frame(conn, 5.0)
    finally:
        done()


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_read_frame_deadline(mod):
    m = tw if mod == "port" else jw
    conn, done = _serve(None)
    t0 = time.time()
    try:
        with pytest.raises(socket.timeout):
            m.read_frame(conn, 0.3)
    finally:
        done()
    assert time.time() - t0 < 5.0


@pytest.mark.parametrize("mod", ["port", "jax"])
@pytest.mark.parametrize("where", [0.1, 0.5, 0.95])
def test_damaged_payload_raises_crc_error(mod, where):
    """A byte flipped in flight (in the header JSON, a length word or a
    leaf body) is a CrcError, never a half-parsed frame."""
    m = tw if mod == "port" else jw
    t, _ = _pair(LEAVES)
    frame = bytearray(tw.pack_frame(HEADER, {"payload": t}))
    pos = tw.PREFIX_LEN + int(where * (len(frame) - tw.PREFIX_LEN))
    frame[pos] ^= 0xFF
    conn, done = _serve(bytes(frame))
    try:
        with pytest.raises(m.CrcError):
            m.read_frame(conn, 5.0)
    finally:
        done()


def test_non_cpu_leaf_is_refused():
    with pytest.raises(tw.WireError, match="CPU tensors"):
        tw.pack_frame({}, {"t": {"x": torch.empty(2, device="meta")}})
