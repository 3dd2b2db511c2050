"""The sharded decode step on a cache whose sequence is split over
``"model"``, on the CPU.

For ``decode_32k`` the reference puts the KV cache's sequence on
``"model"`` (``src/repro/launch/shardings.py``: the GQA kv counts do not
divide the axis; "scores reduce over the sharded seq via a small per-step
all-reduce") and writes the new token with ``.at[bidx, slot].set``, which
GSPMD keeps local.  The port's decode writes the token into the rank's own
shard and attends over its own slots (flash-decoding:
``attention_impl.decode_attention_split``; MLA's absorbed scores the same
way), with the query's heads gathered once.

- Fake process groups (``src_torch/tools/dryrun_sites.py``'s per-site
  charge, smoke configs, the dry-run's ``decode_32k`` pair): a GQA decode
  (Qwen3 on ``(1, 4)`` and ``(2, 2)``, H2O-Danube's rotating window on
  ``(1, 4)``) and an MLA decode (DeepSeek-V2 on ``(2, 2)``) charge no
  all-gather to the cache write or to the decode attention, no gather at
  the attention's sites larger than the step's queries, and in all less
  than one layer's cache shard.
- Gloo ranks (``tests/test_torch_sharded_ranks.py``'s ``_run_ranks``) at
  ``(1, 2)``, ``(2, 2)`` and ``(1, 3)``, fp32, Qwen3, H2O-Danube with a
  12-slot rotating window that wraps, and DeepSeek-V2's MLA with its
  experts (the MoE on local shards, ``models/mlp.py`` ``_moe_local``; 4
  experts on 3 ranks: a slice of the banks each).  One decode layer
  whose two rows write at either side of a shard boundary: the new
  cache bitwise the one the same step writes into the gathered cache,
  and the plain one's but at the new token (whose projections, split over the batch, round
  otherwise).  Ten greedy steps from a 7-token prompt into a 24-slot
  cache (crossing every shard boundary of 2 and 3 ranks) against the
  plain decode: logits within 2e-6 of the largest (at least 1; the
  sharded path before this split already differs by 1.9e-6 at logits of
  2.8), greedy ids exact, the gathered cache bitwise the plain one's but
  at the slots the steps wrote (later layers' new k / v follow the
  earlier layers' flash-decoded attention: within 2e-6), and still split
  over "model" after every step.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import json
import subprocess

import pytest

from test_torch_sharded_ranks import _run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_TORCH = os.path.join(ROOT, "src_torch")

_PROBE = """
import inspect, json, sys
sys.path.insert(0, {tools!r})
import repro_torch.launch.dryrun as D
from repro_torch.config import get_model_config
from repro_torch.models import attention, attention_impl
import dryrun_sites

D.get_model_config = lambda a: get_model_config(a, smoke=True)
arch, mesh = sys.argv[1], tuple(json.loads(sys.argv[2]))
rec, calls = dryrun_sites.trace_sites(arch, "decode_32k", mesh_shape=mesh,
                                      device="cpu")
sites = []
for fn in (attention._write_own_shard, attention._mla_scores,
           attention_impl.decode_attention, attention_impl._decode_scores,
           attention_impl.decode_attention_split,
           attention_impl.split_softmax_combine):
    lines, first = inspect.getsourcelines(fn)
    name = inspect.getsourcefile(fn).rsplit("repro_torch/")[-1]
    sites += [f"{{name}}:{{n}}" for n in range(first, first + len(lines))]
print(json.dumps({{"rec": rec, "calls": calls, "sites": sites}}))
"""

PROBES = {
    "qwen3_1x4": ("qwen3-32b", (1, 4)),
    "qwen3_2x2": ("qwen3-32b", (2, 2)),
    "danube_1x4": ("h2o-danube-1.8b", (1, 4)),
    "deepseek_2x2": ("deepseek-v2-236b", (2, 2)),
}


@pytest.fixture(scope="module")
def traces():
    """Each probe in a process of its own (a dry-run plays rank 0 of a
    fake group), all at once."""
    env = dict(os.environ, PYTHONPATH=SRC_TORCH, OMP_NUM_THREADS="1")
    code = _PROBE.format(tools=os.path.join(SRC_TORCH, "tools"))
    procs = {k: subprocess.Popen(
        [sys.executable, "-c", code, arch, json.dumps(mesh)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, (arch, mesh) in PROBES.items()}
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-3000:]
            out[k] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _smoke(arch):
    from repro_torch.config import INPUT_SHAPES, get_model_config

    return get_model_config(arch, smoke=True), INPUT_SHAPES["decode_32k"]


@pytest.mark.parametrize("probe", list(PROBES))
def test_split_cache_decode_gathers_no_cache(traces, probe):
    got = traces[probe]
    rec = got["rec"]
    assert rec["status"] == "ok", rec
    arch, (data, model) = PROBES[probe]
    cfg, shape = _smoke(arch)
    gathers = [(where, n) for name, where, n in got["calls"]
               if name == "all-gather"]
    # nothing gathered inside the cache write or the decode attention
    inside = [(where, n) for where, n in gathers
              if set(where.replace("bwd ", "").split(" < "))
              & set(got["sites"])]
    assert inside == [], inside
    # at the attention's sites, nothing larger than the step's queries
    # (bf16, every row of the batch, MLA's absorbed q the widest)
    width = max(cfg.resolved_head_dim,
                cfg.mla.kv_lora_rank if cfg.mla else 0)
    q_bytes = shape.global_batch * cfg.num_heads * width * 2
    at_attention = [(where, n) for where, n in gathers
                    if "models/attention" in where]
    assert all(n <= q_bytes for _, n in at_attention), at_attention
    # in all, less than one layer's shard of the cache
    kv = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim if cfg.mla
          else 2 * cfg.num_kv_heads * cfg.resolved_head_dim)
    slots = min(shape.seq_len, cfg.window or shape.seq_len)
    shard = shape.global_batch // data * slots // model * kv * 2
    assert sum(n for _, n in at_attention) < shard, (at_attention, shard)
    # and the layers' new caches are stacked as they come, split
    assert not [w for w, _ in gathers if "models/base.py" in w], gathers


_DECODE = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch.shardings import (batch_shardings, cache_shardings,
                                          params_shardings, rules_for_shape)
from repro_torch.models import attention
from repro_torch.models.base import index_layer

RULES = rules_for_shape(TC.INPUT_SHAPES["decode_32k"])


def setup(arch, B, L, prompt, **over):
    \"\"\"The smoke model in fp32 (DeepSeek-V2 with its experts), its
    params and a prefilled cache, plain and placed by the decode
    rules.\"\"\"
    cfg = TC.get_model_config(arch, smoke=True).replace(dtype="float32",
                                                       **over)
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g)
    last, cache = TS.make_prefill_step(model, max_len=L)(
        params, {"tokens": toks})
    p_d = TS.distribute_tree(params, params_shardings(model, mesh,
                                                      rules=RULES))
    c_d = TS.distribute_tree(cache, cache_shardings(model, B, L, mesh,
                                                    rules=RULES)[0])
    return cfg, model, params, p_d, last, cache, c_d


def model_split(t):
    return t.placements[mesh.mesh_dim_names.index("model")]


def close(a, b, what):
    err = float((a - b).abs().max())
    assert err <= 2e-6 * max(1.0, float(b.abs().max())), (what, err)


def check_layer(arch, B=2, L=24, **over):
    \"\"\"One decode layer on a prefilled cache, two rows writing at either
    side of a shard boundary: the new cache bitwise the one the same step
    writes into the gathered cache, and the plain one's but at the new
    token (whose k / v projections split over the batch round otherwise);
    the token and the output within 2e-6 of the plain ones.\"\"\"
    cfg, model, params, p_d, _, cache, c_d = setup(arch, B, L, 20, **over)
    kind = cfg.layer_kinds[-1]
    slots = next(iter(index_layer(cache["scan_0"], 0).values())).shape[1]
    s = slots // MODEL
    base = slots if cfg.window else 0        # a rotating window wraps
    pos = torch.tensor([[base + s - 1], [base + s]], dtype=torch.int32)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    lc, lc_d = index_layer(cache["scan_0"], 0), index_layer(c_d["scan_0"], 0)
    assert model_split(lc_d["slot_pos"]) == Shard(1), (arch, lc_d)
    kw = dict(mode="decode", kind=kind)
    want, new = attention.apply(index_layer(params["scan_0"]["mix"], 0), x,
                                cfg, positions=pos, cache=lc, **kw)
    place = [Shard(0), Replicate()]

    def run(cache):
        with implicit_replication():
            return attention.apply(
                index_layer(p_d["scan_0"]["mix"], 0),
                distribute_tensor(x, mesh, place), cfg, cache=cache,
                positions=distribute_tensor(pos, mesh, place), **kw)

    got, new_d = sharded(lambda: run(lc_d))
    # the same step with the cache gathered (the write and attention on
    # the whole cache): the write is its bitwise, from the same projections.
    # DTensor's decode on a whole cache with its heads split flattens them,
    # which torch 2.11 refuses (the port takes it only where the cache's
    # sequence is not split over "model"): the yardstick runs under this
    # torch's own rule
    with SR.torch_flatten():
        _, gathered = sharded(lambda: run(
            {k: shlib.gather_dim(t, 1) for k, t in lc_d.items()}))
    close(got.full_tensor(), want, (arch, "y"))
    for name, t in new.items():
        assert model_split(new_d[name]) == Shard(1), (arch, name)
        full = new_d[name].full_tensor()
        assert torch.equal(full, gathered[name].full_tensor()), (arch, name)
        at = torch.arange(B), pos[:, 0] % t.shape[1]
        close(full[at], t[at], (arch, name))
        full[at] = t[at]
        assert torch.equal(full, t), (arch, name)


def check_decode(arch, B=2, L=24, prompt=7, steps=10, **over):
    \"\"\"Greedy decode steps from a prompt of ``prompt`` tokens: logits
    within 2e-6 of the largest, the same ids, the cache bitwise the plain
    one's but at the slots the steps wrote (whose k / v follow the earlier
    layers' attention, within 2e-6), and still split over "model".\"\"\"
    cfg, model, params, p_d, last, cache, c_d = setup(arch, B, L, prompt,
                                                      **over)
    decode = TS.make_decode_step(model)
    t_sh = batch_shardings({"tokens": (B, 1)}, mesh, rules=RULES)["tokens"]
    writes, write = [], attention._write_own_shard

    def counted(*a, **k):
        writes.append(1)
        return write(*a, **k)

    attention._write_own_shard = counted
    tok = torch.argmax(last, -1)[:, None]
    written = {}
    for t in range(steps):
        before = dict(tree_flatten_with_paths(cache))
        want, cache = decode(params, cache, tok)

        def run():
            with implicit_replication():
                return decode(p_d, c_d, TS.distribute_tree(tok, t_sh))

        got, c_d = sharded(run)
        close(got.full_tensor(), want, (arch, t, "logits"))
        ids = torch.argmax(want, -1)
        assert torch.equal(torch.argmax(got.full_tensor(), -1), ids), \\
            (arch, t)
        have = dict(tree_flatten_with_paths(c_d))
        for path, leaf in tree_flatten_with_paths(cache):
            full = have[path].full_tensor()
            if path.endswith("['pos']") or path.endswith("['slot_pos']"):
                assert torch.equal(full, leaf), (arch, t, path)
                if path.endswith("['slot_pos']"):
                    assert model_split(have[path]) == \\
                        Shard(leaf.dim() - 1), (arch, t, path)
                continue
            new = written[path] = written.get(path, False) | (
                before[path] != leaf)
            assert torch.equal(full[~new], leaf[~new]), (arch, t, path)
            close(full, leaf, (arch, t, path))
        tok = ids[:, None]
    attention._write_own_shard = write
    assert writes, arch
"""


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 3)])
def test_split_cache_decode_equals_the_plain_one_on_gloo_ranks(
        data, model, tmp_path):
    _run_ranks(_DECODE + """
for arch, over in (("qwen3-32b", {}), ("h2o-danube-1.8b", {"window": 12}),
                   ("deepseek-v2-236b", {})):
    check_layer(arch, **over)
    check_decode(arch, **over)
""", data, model, tmp_path)
