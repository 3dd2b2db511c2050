"""Where a dry-run pair's collective bytes come from: the pair traced as
``repro_torch.launch.dryrun`` traces it (fake tensors, rank 0 of a fake
process group), each collective's bytes charged to the port's innermost
call sites (``file:line``, the last three frames in ``repro_torch``).
``--layers`` cuts the depth; ``--mesh`` picks the mesh (default 16x16);
``--device cpu`` traces CPU tensors; ``--forward-sites`` charges a
backward pass's collective to the forward call site whose autograd node
runs it (autograd's anomaly mode records those stacks; slower), marked
``bwd``, and names a backward view of ``relaxed_views`` by that forward
site.  It holds a later torch to torch 2.11's rule for a flattening view
(``sharded_ranks.strict_flatten``), as the card's torch counts the
record's ``relaxed_views``.  Prints the record's per-device totals and
relaxed views, then the top sites by bytes.  Run from the root of a
checkout:

    python3 src_torch/tools/dryrun_sites.py --arch h2o-danube-1.8b --layers 2 --device cpu
    python3 src_torch/tools/dryrun_sites.py --arch deepseek-v2-236b --shape decode_32k
    python3 src_torch/tools/dryrun_sites.py --arch yi-34b --layers 1 \\
        --device cpu --forward-sites
"""
import argparse
import collections
import json
import os
import re
import sys
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, ".."), HERE]


def _site(frames) -> str:
    return " < ".join(f"{f.filename.rsplit('repro_torch/')[-1]}:{f.lineno}"
                      for f in frames[-3:][::-1])


def trace_sites(arch: str, shape: str, *, mesh_shape=(16, 16), device=None,
                forward_sites: bool = False, train_cfg=None):
    """``(record, calls)``: the pair's dry-run record and, per collective
    the trace runs, ``(name, site, bytes)`` with the site as
    :func:`main` prints it.  The configuration is
    ``repro_torch.launch.dryrun.get_model_config``'s (patch it to cut
    the model)."""
    from repro_torch.launch import dryrun

    calls = []

    def where_from() -> str:
        stack, mark = traceback.extract_stack(), ""
        node = forward_sites and torch._C._current_autograd_node()
        if node:
            # the stack anomaly mode kept when the forward made this node
            made = "".join(node.metadata.get("traceback_", []))
            stack = [traceback.FrameSummary(f, int(n), "") for f, n in
                     re.findall(r'File "([^"]+)", line (\d+)', made)]
            mark = "bwd "
        return mark + _site([f for f in stack if "repro_torch" in f.filename
                             and f.filename != dryrun.__file__])

    class SiteBytes(dryrun.CollectiveBytes):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.bytes)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for name, total in self.bytes.items():
                added = total - before.get(name, 0.0)
                if added:
                    calls.append((name, where_from(), added))
            return out

    saved = dryrun.CollectiveBytes
    dryrun.CollectiveBytes = SiteBytes
    try:
        with torch.autograd.set_detect_anomaly(forward_sites,
                                               check_nan=False):
            rec = dryrun.run_one(arch, shape, device=device, verbose=False,
                                 mesh_shape=tuple(mesh_shape),
                                 train_cfg=train_cfg)
    finally:
        dryrun.CollectiveBytes = saved
    return rec, calls


def main(argv=None) -> None:
    from repro_torch.config import INPUT_SHAPES, get_model_config
    from repro_torch.launch import dryrun
    from sharded_ranks import strict_flatten

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--shape", default="train_4k", choices=list(INPUT_SHAPES))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--device", default=None)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--forward-sites", action="store_true")
    args = ap.parse_args(argv)
    strict_flatten()

    if args.layers is not None:
        dryrun.get_model_config = lambda a: get_model_config(a).replace(
            num_layers=args.layers)
    rec, calls = trace_sites(
        args.arch, args.shape, device=args.device,
        forward_sites=args.forward_sites,
        mesh_shape=tuple(int(n) for n in args.mesh.split("x")))
    sites = collections.Counter()
    for name, where, nbytes in calls:
        sites[(name, where)] += nbytes
    print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "mesh",
                                              "status", "error", "where",
                                              "per_device", "trace_s",
                                              "relaxed_views")}))
    total = sum(sites.values()) or 1.0
    for (name, where), nbytes in sites.most_common(args.top):
        print(f"{nbytes / 1e9:12.3f} GB {100 * nbytes / total:5.1f}% "
              f"{name:15s} {where}")


if __name__ == "__main__":
    main()
