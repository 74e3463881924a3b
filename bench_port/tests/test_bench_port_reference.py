"""The frozen reference reproduces the repo's interop case byte for byte."""

import hashlib
import json
import os

from bench_port.reference import instances, serde, wire
from bench_port.reference.field import N
from bench_port.reference.merlin import Transcript
from bench_port.reference.rng import ReplayRng, SeededRng

from .conftest import ROOT

SEED = "rust interop case v1"


def _case():
    with open(os.path.join(ROOT, "interop", "u64_case.json")) as fh:
        return json.load(fh)


def test_reference_reproduces_the_interop_case():
    case = _case()
    public = instances.u64_public(SEED)
    assert serde.point_to_hex(public.g) == case["g"]
    assert [serde.point_to_hex(p) for p in public.g_vec] == case["g_vec"]
    assert [serde.point_to_hex(p) for p in public.h_vec] == case["h_vec"]
    rng = SeededRng(SEED)
    rng.scalars(1 + 16 + 32)
    s = rng.scalar()
    assert serde.scalar_to_hex(s) == case["s"]
    blocks = [bytes.fromhex(b) for b in case["draw_blocks"]]
    for i, b in enumerate(blocks):
        c = rng.counter + i
        assert b == (hashlib.sha256(rng.seed + c.to_bytes(8, "little") + b"\x00").digest()
                     + hashlib.sha256(rng.seed + c.to_bytes(8, "little") + b"\x01").digest())
    draws = [int.from_bytes(b, "big") % N for b in blocks]
    assert [serde.scalar_to_hex(d) for d in draws] == case["draws"]
    label = case["transcript_label"].encode()
    com = public.commit_value(case["x"], s)
    assert serde.point_to_hex(com) == case["commitment"]
    proof = public.prove(case["x"], s, Transcript(label), ReplayRng(draws))
    assert serde.reciprocal_proof_to_dict(proof) == case["proof"]

    lane = wire.u64_to_lane(com, proof)
    assert wire.verify_u64_lane(public, lane, label)
    bad = dict(lane, c_s=lane["c_s"][:5] + bytes([lane["c_s"][5] ^ 0x01]) + lane["c_s"][6:])
    assert not wire.verify_u64_lane(public, bad, label)
    bad = dict(lane, wnla_l=[(lane["wnla_l"][0][0] ^ 1,) + lane["wnla_l"][0][1:]] + lane["wnla_l"][1:])
    assert not wire.verify_u64_lane(public, bad, label)
    bad = dict(lane, r=bytes([7]) + lane["r"][1:])
    assert not wire.verify_u64_lane(public, bad, label)
