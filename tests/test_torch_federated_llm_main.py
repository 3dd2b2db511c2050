"""The port's federated-LLM example as its command line runs it, on the CPU.

``main([], device="cpu")`` takes the example's own defaults (small scale:
5.2M parameters, 4 sites, 3 rounds of 10 local steps, 0xF5 TopK deltas at
5%) and exits with "federated loss did not improve" unless the federated
eval loss falls.  About 80 s on the CPU.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))

import numpy as np
import pytest

from repro_torch.examples import federated_llm as mod


@pytest.mark.slow
def test_main_at_its_defaults_improves_its_loss_on_the_cpu():
    history = mod.main([], device="cpu")
    losses = [l for _, l in history.losses()]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(r.metrics.get("wire_codec") == "sparse"
               for r in history.rounds)
    assert all(not r.failures for r in history.rounds), \
        [r.failures for r in history.rounds]
