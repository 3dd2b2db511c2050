"""The port's tracing module (``repro_torch.obs``): spans that cost one
call and one check with no profiler running and record an event under
one; the span names the program opens; the host-link byte counters of
``kernels/agg_reduce.py``; and the fold's spans nested as named on a small
0xF5 round on the CPU.  Every test runs here except the pinned stage's
counter, which needs a card's page-locked memory."""
import ast
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.fl.flat import FlatParams  # noqa: E402
from repro_torch.fl.messages import (FitRes, decode_fit_res,  # noqa: E402
                                     encode_fit_res)
from repro_torch.fl.strategy import make_strategy  # noqa: E402
from repro_torch.kernels import agg_reduce  # noqa: E402

PACKAGE = Path(__file__).resolve().parent.parent / "src_torch" / "repro_torch"


@pytest.fixture
def clean_counts():
    obs.reset_counts()
    yield
    obs.reset_counts()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def test_a_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = obs.span("attention.core"), obs.span("fold.add")
    assert a is b is obs._OFF
    with a:
        pass
    with obs.span(obs.UPDATE_SPAN):
        pass


def test_a_span_records_an_event_under_a_profiler():
    def work():
        with obs.span("fold.finalize"):
            assert torch.autograd._profiler_enabled()
            assert isinstance(obs.span("x"), torch.profiler.record_function)
            torch.ones(4).sum()

    events = _profiled(work)
    spans = [e for e in events if e.name == "fold.finalize"]
    assert len(spans) == 1
    assert any(e.name == "aten::sum" and e.cpu_parent is spans[0]
               for e in events)


def _literal_spans():
    """Every string literal passed to ``obs.span`` in the package."""
    found = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "span" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "obs" and node.args:
                arg = node.args[0]
                name = arg.value if isinstance(arg, ast.Constant) else None
                found.setdefault(name, []).append(
                    f"{path.relative_to(PACKAGE)}:{node.lineno}")
    return found


def test_every_span_the_program_opens_is_listed():
    found = _literal_spans()
    # the update span is opened through its constant, every other by name
    assert [p.split(":")[0] for p in found.pop(None)] == ["train/steps.py"]
    assert set(found) <= set(obs.SPANS), found
    assert set(found) | {obs.UPDATE_SPAN} == set(obs.SPANS)
    assert len(set(obs.SPANS)) == len(obs.SPANS)


def test_the_update_span_keeps_its_name_where_the_benchmark_imports_it():
    from repro_torch.train import steps

    assert steps.UPDATE_SPAN == obs.UPDATE_SPAN == "train_step.update"


def test_counters_add_copy_and_reset(clean_counts):
    obs.count("a", 3)
    obs.count("a", 4)
    obs.count("b", 1)
    got = obs.counts()
    assert got == {"a": 7, "b": 1}
    got["a"] = 0
    assert obs.counts()["a"] == 7
    obs.reset_counts()
    assert obs.counts() == {}


def test_copies_to_a_device_count_their_bytes(clean_counts):
    rng = np.random.default_rng(0)
    a = rng.normal(size=1000).astype(np.float32)
    rows = [rng.integers(-127, 128, 777, dtype=np.int8) for _ in range(3)]
    t = agg_reduce.to_device(a, torch.device("meta"))
    s = agg_reduce.stack_to_device(rows, "meta")
    assert t.device.type == s.device.type == "meta"
    assert obs.counts() == {"copy.h2d_bytes.pageable":
                            a.nbytes + sum(r.nbytes for r in rows)}


def test_copies_from_a_device_count_their_bytes(clean_counts, monkeypatch):
    # a meta tensor holds no data to copy out: stand in for the copy
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: torch.zeros(
        t.shape, dtype=t.dtype) if t.device.type == "meta" else cpu(t))
    h = agg_reduce.to_host(torch.empty((5, 7), dtype=torch.float64,
                                       device="meta"))
    assert h.shape == (5, 7)
    assert obs.counts() == {"copy.d2h_bytes.pageable": 5 * 7 * 8}


def test_copies_within_the_cpu_count_nothing(clean_counts):
    a = np.arange(100, dtype=np.float64)
    t = agg_reduce.to_device(a, "cpu")
    agg_reduce.stack_to_device([a, a], torch.device("cpu"))
    assert agg_reduce.to_host(t).tobytes() == a.tobytes()
    assert obs.counts() == {}


def _sparse_round(sites=3):
    """Base arrays and the sites' decoded 0xF5 results against them."""
    rng = np.random.default_rng(5)
    base = [rng.normal(0, 0.5, s).astype(np.float32)
            for s in ((33, 17), (1500,), (2048,))]
    frames = []
    for i in range(sites):
        arrays = [b + rng.normal(0, 1e-3, b.shape).astype(np.float32)
                  for b in base]
        frames.append(encode_fit_res(FitRes(arrays, 10 + 3 * i, {}),
                                     codec="sparse",
                                     base=FlatParams.from_arrays(base),
                                     sparse_frac=0.05))
    return base, frames


def _nearest_span(e):
    """The innermost program span that holds event ``e``."""
    p = e.cpu_parent
    while p is not None and p.name not in obs.SPANS:
        p = p.cpu_parent
    return None if p is None else p.name


def test_a_sparse_fold_opens_its_spans_nested_as_named():
    base, frames = _sparse_round()
    flat = FlatParams.from_arrays(base)

    def fold():
        acc = make_strategy("fedavg", backend="torch",
                            device="cpu").fit_accumulator(1, base)
        for i, frame in enumerate(frames):
            res = decode_fit_res(frame)
            res.sparse.base = flat
            acc.add(f"site-{i}", res)
        return acc.finalize([])

    out = []
    events = _profiled(lambda: out.append(fold()))
    assert out[0][0][0].shape == (33, 17)
    opened = {}
    for e in events:
        if e.name in obs.SPANS:
            opened.setdefault(e.name, set()).add(_nearest_span(e))
    sites = len(frames)
    counts = {n: sum(e.name == n for e in events) for n in opened}
    assert counts["fl.decode"] == counts["fl.decode.header"] == sites
    assert counts["fl.decode.check"] == sites
    assert counts["fold.add"] == counts["fold.add.scatter"] == sites
    assert counts["fold.finalize"] == 1
    # a child inside its parent, whose name begins its own
    assert opened["fl.decode"] == {None}
    assert opened["fl.decode.header"] == {"fl.decode"}
    assert opened["fl.decode.check"] == {"fl.decode"}
    assert opened["fold.add"] == {None}
    assert opened["fold.add.stage"] == {"fold.add"}
    assert opened["fold.add.scatter"] == {"fold.add"}
    assert opened["fold.finalize"] == {None}
    for child in ("close", "cast", "download", "assemble"):
        assert opened[f"fold.finalize.{child}"] == {"fold.finalize"}
    # the copies inside whichever span made them: the round base's upload
    # and its weight in close, the result's download
    assert opened["copy.h2d"] == {"fold.finalize.close"}
    assert opened["copy.d2h"] == {"fold.finalize.download"}


def test_a_traced_fold_is_the_untraced_fold():
    base, frames = _sparse_round(sites=2)
    flat = FlatParams.from_arrays(base)

    def fold():
        acc = make_strategy("fedavg", backend="torch",
                            device="cpu").fit_accumulator(1, base)
        for i, frame in enumerate(frames):
            res = decode_fit_res(frame)
            res.sparse.base = flat
            acc.add(f"site-{i}", res)
        return acc.finalize([])[0]

    plain = fold()
    traced = []
    _profiled(lambda: traced.append(fold()))
    for a, b in zip(plain, traced[0]):
        assert a.tobytes() == b.tobytes()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned stage's page-locked "
                    "buffer exists only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_pinned_stage_counts_its_bytes(cuda_device, clean_counts):
    rng = np.random.default_rng(1)
    arrays = (rng.integers(-127, 128, 3001, dtype=np.int8),
              rng.normal(size=5).astype(np.float32), None,
              np.arange(3001, dtype=np.int64))
    out = agg_reduce.PinnedStage().to_device(arrays, cuda_device)
    torch.cuda.synchronize(cuda_device)
    for a, t in zip(arrays, out):
        assert (a is None and t is None) or \
            t.cpu().numpy().tobytes() == a.tobytes()
    got = obs.counts()
    assert got["copy.h2d_bytes.pinned"] == sum(
        a.nbytes for a in arrays if a is not None)
    assert "copy.h2d_bytes.pageable" not in got
    h = agg_reduce.to_host(out[3])
    assert h.tobytes() == arrays[3].tobytes()
    assert obs.counts()["copy.d2h_bytes.pageable"] == arrays[3].nbytes
