"""The port's wire layer against the reference's, byte for byte.

- ``repro_torch.utils.msgpack_lite`` packs exactly the bytes ``msgpack``
  packs and unpacks them to equal objects;
- bf16 narrowing/widening without ``ml_dtypes`` gives ``ml_dtypes``' bits;
- every message frame (flat/bf16/q8/q8-delta/sparse/partial/legacy, the
  metric batch) is byte-identical to the reference's and decodes both
  ways; reserved version bytes raise ``UnsupportedCodec``.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import ml_dtypes
import msgpack
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

import repro.fl.flat as RF
import repro.fl.messages as RM
import repro.runtime.streaming as RS
import repro_torch.fl.flat as TF
import repro_torch.fl.messages as TM
import repro_torch.runtime.streaming as TS
from repro_torch.utils import msgpack_lite

RNG_SEED = 11


# ---------------------------------------------------------------------------
# msgpack_lite == msgpack
# ---------------------------------------------------------------------------
def _tree(rng: np.random.Generator, depth: int = 0):
    kind = int(rng.integers(0, 9 if depth < 3 else 6))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        lo = [-(1 << 63), -(1 << 31), -129, -33, 0][int(rng.integers(0, 5))]
        hi = [127, 255, 1 << 16, 1 << 32, (1 << 64) - 1][int(rng.integers(0, 5))]
        return int(rng.integers(0, 1 << 62)) % (hi - lo + 1) + lo
    if kind == 3:
        return float(rng.normal() * 10.0 ** int(rng.integers(-300, 300)))
    if kind == 4:
        n = int(rng.choice([0, 5, 31, 32, 300]))
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, n))
    if kind == 5:
        return bytes(rng.integers(0, 256, int(rng.choice([0, 7, 256])),
                                  dtype=np.uint8))
    if kind in (6, 7):
        n = int(rng.choice([0, 3, 15, 16, 17]))
        items = [_tree(rng, depth + 1) for _ in range(n)]
        return items if kind == 6 else tuple(items)
    n = int(rng.choice([0, 2, 15, 16]))
    return {f"k{i}_{int(rng.integers(0, 99))}": _tree(rng, depth + 1)
            for i in range(n)}


def _plain(x):
    """msgpack unpacks tuples as lists."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_msgpack_lite_matches_msgpack_on_random_trees(seed):
    tree = _tree(np.random.default_rng(seed))
    ref = msgpack.packb(tree, use_bin_type=True)
    got = msgpack_lite.packb(tree, use_bin_type=True)
    assert got == ref
    assert msgpack_lite.unpackb(ref, raw=False) == _plain(tree)
    assert msgpack_lite.unpackb(memoryview(got), raw=False) \
        == msgpack.unpackb(ref, raw=False)


_POWERS = (5, 7, 8, 15, 16, 31, 32, 63)
_INTS = sorted(v for v in {s * (1 << k) + d for k in _POWERS
                            for s in (1, -1) for d in (-1, 0, 1)}
               | {0, (1 << 64) - 1} if -(1 << 63) <= v < (1 << 64))
_LENGTHS = (0, 1, 31, 32, 255, 256, 65535, 65536)


@pytest.mark.parametrize("case", [
    *[("int", v) for v in _INTS],
    *[("str", n) for n in _LENGTHS],
    *[("bin", n) for n in _LENGTHS],
    *[("list", n) for n in (0, 15, 16, 65535, 65536)],
    *[("map", n) for n in (0, 15, 16, 65536)],
    ("float", -0.0), ("float", 1e308), ("float", 5e-324),
    ("misc", None), ("misc", True), ("misc", False),
], ids=str)
def test_msgpack_lite_boundaries(case):
    kind, v = case
    obj = {"int": lambda: v, "float": lambda: v, "misc": lambda: v,
           "str": lambda: "x" * v, "bin": lambda: b"\x01" * v,
           "list": lambda: list(range(v)),
           "map": lambda: {str(i): i for i in range(v)}}[kind]()
    ref = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj, use_bin_type=True) == ref
    assert msgpack_lite.unpackb(ref, raw=False) == \
        msgpack.unpackb(ref, raw=False)


def test_msgpack_lite_rejects_what_msgpack_rejects():
    for v in (1 << 64, -(1 << 63) - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(v)
        with pytest.raises(OverflowError):
            msgpack_lite.packb(v)
    with pytest.raises(TypeError):
        msgpack_lite.packb({1, 2})
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb("abc")[:-1])


# ---------------------------------------------------------------------------
# bf16 without ml_dtypes
# ---------------------------------------------------------------------------
def _special_f32() -> np.ndarray:
    bits = np.array([0, 1, 2, 32767, 32768, 32769, 98304, 8388607, 8388608,
                     1065385984, 1065451520, 2139095040, 2139095039,
                     2139127807, 2139127808, 2143289344, 2139095041],
                    np.uint32)
    bits = np.concatenate([bits, bits | np.uint32(1 << 31)])
    return bits.view(np.float32)


@pytest.mark.parametrize("src", ["float32", "float64"])
def test_bf16_narrowing_matches_ml_dtypes(src):
    rng = np.random.default_rng(RNG_SEED)
    with np.errstate(invalid="ignore"):
        specials = _special_f32().astype(src)
    x = np.concatenate([
        specials,
        rng.normal(0, 1, 4096).astype(src),
        (rng.normal(0, 1, 512) * 1e-39).astype(src),         # subnormal
        np.array([1 + 2**-8 + 2**-40, -(1 + 2**-8 + 2**-40)]).astype(src),
        np.array([np.inf, -np.inf, np.nan, -np.nan]).astype(src),
    ])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = TF.to_bf16(x)
    assert TF.is_bf16(got.dtype)
    np.testing.assert_array_equal(got.view(np.uint16), want)


def test_bf16_double_rounding_case_is_kept():
    # ml_dtypes rounds fp64 -> fp32 -> bf16: 1 + 2**-8 + 2**-40 becomes 1.0
    got = TF.to_bf16(np.array([1 + 2**-8 + 2**-40]))
    assert TF.bf16_to_f32(got)[0] == np.float32(1.0)


def test_bf16_widening_matches_ml_dtypes():
    bits = np.arange(1 << 16, dtype=np.uint16)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    got = TF.bf16_to_f32(bits)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# frames: byte-identical and cross-decodable
# ---------------------------------------------------------------------------
SIG = [("float32", (3, 5)), ("float32", (17,)), ("float32", ()),
       ("float32", (1100,))]
MIXED = [("float64", (4,)), ("float16", (3, 2)), ("bfloat16", (5,)),
         ("int32", (2,))]


def _arrays(sig, seed):
    """(reference arrays, port arrays): the same bytes, bf16 as ml_dtypes
    values on the reference side and as bit storage on the port's."""
    rng = np.random.default_rng(seed)
    ref, port = [], []
    for d, shape in sig:
        a = np.asarray(rng.normal(0, 1, shape) * 3).astype(RF.np_dtype(d))
        ref.append(a)
        port.append(a.view(np.uint16).view(TF.np_dtype(d))
                    if d == "bfloat16" else a.copy())
    return ref, port


def _assert_same_arrays(ra, ta):
    assert len(ra) == len(ta)
    for r, t in zip(ra, ta):
        assert r.shape == t.shape
        assert r.tobytes() == t.tobytes()
        assert RF.layout_of([r]).signature == TF.layout_of([t]).signature


def _fit_cases():
    cfg = {"round": 3, "lr": 0.5, "name": "x", "flag": True, "b": b"\x01"}
    return [("flat", SIG, None, False), ("legacy", SIG, "legacy", False),
            ("mixed", MIXED, None, False), ("mixed_legacy", MIXED, "legacy",
                                            False),
            ("bf16", SIG, "bf16", False), ("bf16_delta", SIG, "bf16", True),
            ("q8", SIG, "q8", False), ("q8_delta", SIG, "q8", True),
            ("sparse", SIG, "sparse", True)], cfg


@pytest.mark.parametrize("case", _fit_cases()[0], ids=lambda c: c[0])
def test_fit_frames_byte_identical_and_cross_decode(case):
    name, sig, codec, delta = case
    cfg = _fit_cases()[1]
    ra, ta = _arrays(sig, 1)
    rb, tb = _arrays(sig, 2)
    rbase = RF.FlatParams.from_arrays(rb) if delta else None
    tbase = TF.FlatParams.from_arrays(tb) if delta else None
    rres = RM.FitRes(ra, 96, {"train_loss": 0.25, "n": 3})
    tres = TM.FitRes(ta, 96, {"train_loss": 0.25, "n": 3})
    got = TM.encode_fit_res(tres, codec=codec, base=tbase)
    want = RM.encode_fit_res(rres, codec=codec, base=rbase)
    assert got == want
    # FitIns / EvaluateIns carry the same parameter frames (no deltas)
    if not delta:
        assert TM.encode_fit_ins(TM.FitIns(ta, cfg), codec=codec) == \
            RM.encode_fit_ins(RM.FitIns(ra, cfg), codec=codec)
        assert TM.encode_evaluate_ins(TM.EvaluateIns(ta, cfg),
                                      codec=codec) == \
            RM.encode_evaluate_ins(RM.EvaluateIns(ra, cfg), codec=codec)
    # cross decode, both directions
    for enc, dec, base in ((got, RM.decode_fit_res, rbase),
                           (want, TM.decode_fit_res, tbase)):
        res = dec(enc)
        assert res.num_examples == 96 and res.metrics["n"] == 3
        if res.sparse is not None:
            res.sparse.base = base
            vec = res.sparse.to_f64()
        elif res.quant is not None:
            res.quant.base = base
            vec = res.quant.to_f64()
        else:
            vec = None
            other = (TM.decode_fit_res(enc) if dec is RM.decode_fit_res
                     else RM.decode_fit_res(enc))
            pair = (res, other) if dec is RM.decode_fit_res else (other, res)
            _assert_same_arrays(pair[0].parameters, pair[1].parameters)
        if vec is not None:
            other = (TM.decode_fit_res(got) if dec is RM.decode_fit_res
                     else RM.decode_fit_res(want))
            o = other.sparse if other.sparse is not None else other.quant
            o.base = tbase if dec is RM.decode_fit_res else rbase
            np.testing.assert_array_equal(vec, o.to_f64())


def test_bf16_params_decode_to_bits_and_reencode_identically():
    ra, ta = _arrays(MIXED, 3)
    want = RM.arrays_to_bytes(ra)
    back = TM.bytes_to_arrays(want)          # bf16 leaf comes back as bits
    assert TF.is_bf16(back[2].dtype) and back[2].dtype == np.uint16
    assert TM.arrays_to_bytes(back) == want
    assert TM.arrays_to_bytes(back, codec="legacy") == \
        RM.arrays_to_bytes(ra, codec="legacy")
    _assert_same_arrays(RM.bytes_to_arrays(TM.arrays_to_bytes(ta)), back)


def test_envelopes_byte_identical_and_cross_decode():
    payload = bytes(range(200)) * 3
    pairs = [
        (TM.encode_task_ins(TM.TaskIns("fit", 2, payload, "t1", "g")),
         RM.encode_task_ins(RM.TaskIns("fit", 2, payload, "t1", "g"))),
        (TM.encode_task_res(TM.TaskRes("fit", 2, payload, "t1", "err")),
         RM.encode_task_res(RM.TaskRes("fit", 2, payload, "t1", "err"))),
        (TM.encode_evaluate_res(TM.EvaluateRes(0.125, 7, {"accuracy": 0.5})),
         RM.encode_evaluate_res(RM.EvaluateRes(0.125, 7, {"accuracy": 0.5}))),
        (TM.encode_properties_res({"codecs": list(TM.WIRE_CODECS)}),
         RM.encode_properties_res({"codecs": list(RM.WIRE_CODECS)})),
    ]
    for got, want in pairs:
        assert got == want
    assert TM.decode_task_ins(memoryview(pairs[0][1])) == \
        TM.TaskIns(**vars(RM.decode_task_ins(pairs[0][0])))
    assert vars(TM.decode_task_res(pairs[1][1])) == \
        vars(RM.decode_task_res(pairs[1][0]))
    assert vars(TM.decode_evaluate_res(pairs[2][1])) == \
        vars(RM.decode_evaluate_res(pairs[2][0]))


def test_partial_frame_byte_identical_and_cross_decode():
    rng = np.random.default_rng(4)
    rl, tl = RF.layout_for(SIG), TF.layout_for(SIG)
    vec = rng.normal(0, 1, tl.total_size)
    got = TM.encode_partial_fit_res(TF.PartialSum(
        tl, vec, 12.5, 3, ("a", "b"), (("c", "timeout"),)), {"m": 1})
    want = RM.encode_partial_fit_res(RF.PartialSum(
        rl, vec, 12.5, 3, ("a", "b"), (("c", "timeout"),)), {"m": 1})
    assert got == want
    for dec, enc in ((RM.decode_fit_res, got), (TM.decode_fit_res, want)):
        p = dec(enc).partial
        assert p.total_w == 12.5 and p.count == 3
        np.testing.assert_array_equal(p.data, vec)


def test_metric_batch_byte_identical():
    items = [("site-1/loss", 0.5, 3), ("site-2/acc", 0.25, 4)]
    assert TS._encode_batch(items) == RS._encode_batch(items)
    assert TS._decode_batch(RS._encode_batch(items)) == items
    assert TS._encode("t", 1.5, 2) == RS._encode("t", 1.5, 2)


def test_reserved_version_bytes_raise_unsupported_codec():
    known = {TF.WIRE_MAGICS[k] for k in TF.PAYLOAD_CODEC_MAGICS}
    tail = bytes(16)
    for b in range(TF.WIRE_MAGIC_LO, TF.WIRE_MAGIC_HI + 1):
        if b in known:
            continue
        frame = bytes([b]) + tail
        with pytest.raises(TM.UnsupportedCodec):
            TM.decode_fit_res(frame)
        with pytest.raises(RM.UnsupportedCodec):
            RM.decode_fit_res(frame)
