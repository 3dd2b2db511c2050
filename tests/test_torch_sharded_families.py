"""Whisper and InternVL2 on real gloo ranks, with their embeddings, and
the batches they are given, on the CPU.

- ``Model.make_batch`` (``repro_torch/models/api.py``) against the
  reference's (``src/repro/models/api.py``): the same keys, dtypes and
  arrays, bit for bit, from the same seed, for a train, a prefill and a
  decode shape and for the (batch, sequence) form, of Whisper (audio
  frames) and InternVL2 (prefix patch embeddings).
- Through ``src_torch/tools/sharded_ranks.py`` (one interpreter a rank,
  fp32 smoke configs): each one's sharded prefill (``prefill_32k`` rules),
  4 greedy decode steps (``decode_32k`` rules) from the plain prefill's
  cache and one train step on ``(1, 2)``, Whisper's audio embeddings and
  InternVL2's prefix embeddings placed with the batch, against the plain
  ones at the tool's tolerances (logits within 1e-5 / 2e-6 of the
  largest, the same ids; loss, grad norm and Adam moments at the sharded
  step's).
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch",
                                "tools"))

import numpy as np
import pytest

import repro.config as RC
import repro_torch.config as TC
from repro.models.api import build_model as ref_build_model
from repro_torch.models import build_model

import sharded_ranks as SR

RANK_TIMEOUT = 240
FAMILIES = ("whisper-medium", "internvl2-1b")
SHAPES = (("train", 12, 3), ("prefill", 20, 2), ("decode", 64, 4))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind,seq,batch", SHAPES)
def test_make_batch_equals_the_references(arch, kind, seq, batch):
    model = build_model(TC.get_model_config(arch, smoke=True))
    ref = ref_build_model(RC.get_model_config(arch, smoke=True))
    got = model.make_batch(TC.InputShape(kind, seq, batch, kind), seed=5)
    want = ref.make_batch(RC.InputShape(kind, seq, batch, kind), seed=5)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["tokens"].shape == (batch, 1 if kind == "decode" else seq)
    extra = "audio_embeds" if arch.startswith("whisper") else "extra_embeds"
    assert (extra in got) == (kind != "decode")


@pytest.mark.parametrize("arch", FAMILIES)
def test_make_batch_of_a_batch_size_is_the_references_train_batch(arch):
    model = build_model(TC.get_model_config(arch, smoke=True))
    ref = ref_build_model(RC.get_model_config(arch, smoke=True))
    got, want = model.make_batch(3, 10, seed=9), ref.make_batch(3, 10, seed=9)
    assert list(got) == list(want) and "labels" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_steps_with_embeddings_equal_the_plain_ones(arch, tmp_path):
    SR.run_ranks(f"""
SR.check_prefill(mesh, {arch!r})
res = SR.check_decode(mesh, {arch!r})
assert res["steps"] == 4, res
SR.check_step(mesh, {arch!r}, 32)
""", 1, 2, tmp_path, RANK_TIMEOUT)
