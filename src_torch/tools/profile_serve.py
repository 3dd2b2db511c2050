"""Where the serving path's time goes on the card: a registered model at
full width (``--arch``, default H2O-Danube-1.8B), ``--batch`` requests x
``--prompt`` prompt tokens (default 4 x 4500), random weights from seed 0;
``--layers`` cuts the depth (DeepSeek-V2-236B does not fit one card whole).
An encoder-decoder model's requests carry ``cfg.encoder_seq`` audio frames
(seeded normals).

Times two prefills and a few decode steps on the host clock (each ending
in a device sync; the first of each is the warm-up), decode steps with
PyTorch's deterministic mode off as well, then prints
``torch.profiler`` tables (device and host time by op) for two decode
steps and one prefill.  ``--split`` first times one more prefill by
block on the host clock, each block call between two device syncs (the
outermost call of each kind counts; the rest of the prefill is
``other``): where the time of a launch-bound block such as the sLSTM's
sequential loop goes.  Run from the root of a checkout on a machine with
one NVIDIA H100:

    python3 src_torch/tools/profile_serve.py
    python3 src_torch/tools/profile_serve.py --arch recurrentgemma-2b --prompt 4096
    python3 src_torch/tools/profile_serve.py --arch deepseek-v2-236b --layers 2 --batch 1 --prompt 2048
    python3 src_torch/tools/profile_serve.py --arch xlstm-350m --prompt 2048 --split
    python3 src_torch/tools/profile_serve.py --arch whisper-medium --prompt 256 --split
"""
import argparse
import os
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from repro_torch.config import get_model_config  # noqa: E402
from repro_torch.models import (attention, build_model, encdec, mlp,  # noqa: E402
                                recurrent)
from repro_torch.train.steps import make_decode_step, make_prefill_step  # noqa: E402

NEW = 32


def _ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _table(prof, key: str) -> str:
    return prof.key_averages().table(sort_by=key, row_limit=25)


#: the blocks ``--split`` times: (module, function name)
SPLIT = ((recurrent, "mlstm_apply"), (recurrent, "slstm_apply"),
         (recurrent, "rglru_apply"), (encdec, "encode"),
         (encdec, "cross_kv"), (encdec, "cross_apply"),
         (attention, "apply"), (mlp, "apply"), (mlp, "moe_apply"))


def split_ms(run) -> dict:
    """Host ms of ``run()`` by block: each outermost call of a block of
    SPLIT between two device syncs; ``other`` is the rest."""
    acc, depth, saved = {}, [0], []

    def timed(name, fn):
        def call(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
                depth[0] -= 1
        return call

    for mod, name in SPLIT:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, timed(f"{mod.__name__.split('.')[-1]}.{name}", fn))
    try:
        total, _ = _ms(run)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    acc["other"] = total - sum(acc.values())
    acc["total"] = total
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=4500)
    ap.add_argument("--layers", type=int, default=0,
                    help="layers to run (default: the config's depth)")
    ap.add_argument("--split", action="store_true",
                    help="time one more prefill by block first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA card", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device("cuda")
    cfg = get_model_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt))).to(dev)}
    if cfg.is_encoder_decoder:
        batch["audio_embeds"] = torch.from_numpy(rng.normal(size=(
            args.batch, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)).to(dev)
    print(f"{cfg.name}: {cfg.num_layers} layers, {args.batch} x "
          f"{args.prompt} prompt tokens", flush=True)
    prefill = make_prefill_step(model, max_len=args.prompt + NEW,
                                impl="flash")
    decode = make_decode_step(model, impl="flash")
    for _ in range(2):
        ms, (last, cache) = _ms(lambda: prefill(params, batch))
        print("prefill ms", ms, flush=True)
    if args.split:
        print("prefill split ms", split_ms(lambda: prefill(params, batch)),
              flush=True)
    tok = torch.argmax(last, -1)[:, None]
    for deterministic in (True, False):
        torch.use_deterministic_algorithms(deterministic)
        steps = []
        for _ in range(5):
            ms, (last, cache) = _ms(lambda: decode(params, cache, tok))
            steps.append(ms)
        print(f"decode ms per step (deterministic={deterministic})", steps,
              flush=True)
    torch.use_deterministic_algorithms(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            last, cache = decode(params, cache, tok)
        torch.cuda.synchronize()
    print("two decode steps", flush=True)
    print(_table(prof, "cuda_time_total"), flush=True)
    print(_table(prof, "cpu_time_total"), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    print("one prefill", flush=True)
    print(_table(prof, "cuda_time_total"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
