"""Port parity, the FGSS ``StreamState`` wire format
(``repro_torch.serve.fleet.wire``): blobs are byte-identical across the two
packages in both directions, and every truncation or single-bit flip of a
blob raises the port's typed errors, as ``tests/test_wire.py`` holds the
reference to."""
import numpy as np
import pytest

from repro.core import quantization as jq
from repro.serve.fleet import wire as jwire
from repro.serve.streaming import StreamingConfig as JConfig
from repro.serve.streaming import StreamingEngine as JEngine
from repro.serve.streaming import StreamState as JState
from repro_torch.core import quantization as q
from repro_torch.serve.fleet import wire
from repro_torch.serve.fleet.wire import (WireCorruptError, WireError,
                                          WireTruncatedError, WireVersionError,
                                          decode_stream_state,
                                          encode_stream_state)
from repro_torch.serve.streaming import (StreamState, StreamingConfig,
                                         StreamingEngine)
from torchharness import np_params


def fields(samples_rows=7, traj_rows=3, total=300, record=True, seed=0):
    rng = np.random.default_rng(seed)
    H, d = 16, 3
    return dict(
        stream_id=f"sensor-{seed}",
        h=rng.standard_normal(H).astype(np.float32),
        steps=131, wstep=3, total=total,
        samples=rng.standard_normal((samples_rows, d)).astype(np.float32),
        record_trajectory=record,
        trajectory=[rng.standard_normal(H).astype(np.float32)
                    for _ in range(traj_rows)])


STATES = {
    "full": fields(),
    "empty-buffers-open": fields(samples_rows=0, traj_rows=0, total=None,
                                 record=False, seed=1),
    "one-sample": fields(samples_rows=1, traj_rows=0, total=128, seed=2),
}


def assert_states_equal(a, b) -> None:
    assert (a.stream_id, a.steps, a.wstep, a.total, a.record_trajectory) == \
        (b.stream_id, b.steps, b.wstep, b.total, b.record_trajectory)
    for x, y in [(a.h, b.h), (a.samples, b.samples)] + list(
            zip(a.trajectory, b.trajectory)):
        np.testing.assert_array_equal(np.asarray(x).view(np.int32),
                                      np.asarray(y).view(np.int32))
    assert len(a.trajectory) == len(b.trajectory)


@pytest.mark.parametrize("name", list(STATES))
def test_blobs_identical_across_packages_both_ways(name):
    f = STATES[name]
    blob = encode_stream_state(StreamState(**f))
    assert jwire.encode_stream_state(JState(**f)) == blob
    # port -> reference -> port, and reference -> port -> reference
    from_port = jwire.decode_stream_state(blob)
    assert jwire.encode_stream_state(from_port) == blob
    from_ref = decode_stream_state(jwire.encode_stream_state(JState(**f)))
    assert encode_stream_state(from_ref) == blob
    assert_states_equal(from_ref, StreamState(**f))
    assert_states_equal(from_port, from_ref)


def test_live_engine_snapshots_identical_across_packages():
    """Snapshots taken off running engines of both packages (same weights,
    same samples, same ticks) encode to the same bytes, and each package
    resumes the other's blob."""
    p = np_params(0)
    qp, jqp = q.quantize_params(p, q.QuantConfig()), \
        jq.quantize_params(p, jq.QuantConfig())
    eng = StreamingEngine(qp, StreamingConfig(max_slots=4, device="cpu"))
    ref = JEngine(jqp, JConfig(max_slots=4))
    w = np.random.default_rng(0).standard_normal((200, 3)).astype(np.float32)
    for e in (eng, ref):
        e.attach("s", w, total_steps=200, record_trajectory=True)
        for _ in range(90):
            e.step()
    blob = encode_stream_state(eng.snapshot_stream("s"))
    assert jwire.encode_stream_state(ref.snapshot_stream("s")) == blob
    a = StreamingEngine(qp, StreamingConfig(max_slots=4, device="cpu"))
    b = JEngine(jqp, JConfig(max_slots=4))
    a.import_stream(decode_stream_state(blob))
    b.import_stream(jwire.decode_stream_state(blob))
    rest_a = [e for _ in range(200) for e in a.step()]
    rest_b = [e for _ in range(200) for e in b.step()]
    assert [(e.kind, e.step, e.logits.tobytes()) for e in rest_a] == \
           [(e.kind, e.step, e.logits.tobytes()) for e in rest_b]
    assert rest_a


def test_every_truncation_raises():
    blob = encode_stream_state(StreamState(**STATES["full"]))
    for n in range(len(blob)):
        with pytest.raises(WireError):
            decode_stream_state(blob[:n])


def test_every_single_bit_flip_raises():
    blob = bytearray(encode_stream_state(StreamState(
        **fields(samples_rows=2, traj_rows=1))))
    for i in range(len(blob)):
        for bit in range(8):
            blob[i] ^= 1 << bit
            with pytest.raises(WireError):
                decode_stream_state(bytes(blob))
            blob[i] ^= 1 << bit
    decode_stream_state(bytes(blob))


def _repack_version(blob: bytes, major: int, minor: int) -> bytes:
    _, _, _, hlen, hcrc = wire._PREAMBLE.unpack_from(blob, 0)
    return wire._PREAMBLE.pack(wire.MAGIC, major, minor, hlen,
                               hcrc) + blob[wire._PREAMBLE.size:]


def test_typed_refusals():
    blob = encode_stream_state(StreamState(**STATES["full"]))
    with pytest.raises(WireError, match="trailing"):
        decode_stream_state(blob + b"\x00")
    with pytest.raises(WireError, match="magic"):
        decode_stream_state(b"FGAR" + blob[4:])
    with pytest.raises(WireVersionError, match="newer minor.*upgrade"):
        decode_stream_state(_repack_version(blob, wire.WIRE_MAJOR,
                                            wire.WIRE_MINOR + 1))
    with pytest.raises(WireVersionError, match="major"):
        decode_stream_state(_repack_version(blob, wire.WIRE_MAJOR + 1, 0))
    with pytest.raises(WireTruncatedError, match="payload"):
        decode_stream_state(blob[:-8])
    flipped = bytearray(blob)
    idx = blob.index(b'"steps":131') + len('"steps":13')
    flipped[idx] ^= 0x01
    with pytest.raises(WireCorruptError, match="header crc32"):
        decode_stream_state(bytes(flipped))
