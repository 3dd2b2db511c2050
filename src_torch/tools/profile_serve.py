"""Where the serving path's time goes on the card: a registered model at
full width (``--arch``, default H2O-Danube-1.8B), ``--batch`` requests x
``--prompt`` prompt tokens (default 4 x 4500), random weights from seed 0;
``--layers`` cuts the depth (DeepSeek-V2-236B does not fit one card whole).

Times two prefills and a few decode steps on the host clock (each ending
in a device sync; the first of each is the warm-up), decode steps with
PyTorch's deterministic mode off as well, then prints
``torch.profiler`` tables (device and host time by op) for two decode
steps and one prefill.  Run from the root of a checkout on a machine with
one NVIDIA H100:

    python3 src_torch/tools/profile_serve.py
    python3 src_torch/tools/profile_serve.py --arch recurrentgemma-2b --prompt 4096
    python3 src_torch/tools/profile_serve.py --arch deepseek-v2-236b --layers 2 --batch 1 --prompt 2048
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
from repro_torch.models import build_model  # noqa: E402
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=4500)
    ap.add_argument("--layers", type=int, default=0,
                    help="layers to run (default: the config's depth)")
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
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt))).to(dev)
    print(f"{cfg.name}: {cfg.num_layers} layers, {args.batch} x "
          f"{args.prompt} prompt tokens", flush=True)
    prefill = make_prefill_step(model, max_len=args.prompt + NEW,
                                impl="flash")
    decode = make_decode_step(model, impl="flash")
    for _ in range(2):
        ms, (last, cache) = _ms(lambda: prefill(params, {"tokens": tokens}))
        print("prefill ms", ms, flush=True)
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
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    print("one prefill", flush=True)
    print(_table(prof, "cuda_time_total"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
