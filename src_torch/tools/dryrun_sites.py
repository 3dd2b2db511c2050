"""Where a dry-run pair's collective bytes come from: the pair traced as
``repro_torch.launch.dryrun`` traces it (fake tensors, rank 0 of a fake
process group), each collective's bytes charged to the port's innermost
call sites (``file:line``, the last three frames in ``repro_torch``).
``--layers`` cuts the depth; ``--mesh`` picks the mesh (default 16x16);
``--device cpu`` traces CPU tensors.  Prints the record's per-device
totals, then the top sites by bytes.  Run from the root of a checkout:

    python3 src_torch/tools/dryrun_sites.py --arch h2o-danube-1.8b --layers 2 --device cpu
    python3 src_torch/tools/dryrun_sites.py --arch deepseek-v2-236b --shape decode_32k
"""
import argparse
import collections
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> None:
    from repro_torch.config import INPUT_SHAPES, get_model_config
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--shape", default="train_4k", choices=list(INPUT_SHAPES))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--device", default=None)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    sites = collections.Counter()

    class SiteBytes(dryrun.CollectiveBytes):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.bytes)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for name, total in self.bytes.items():
                added = total - before.get(name, 0.0)
                if added:
                    frames = [f for f in traceback.extract_stack()
                              if "repro_torch" in f.filename
                              and f.filename != dryrun.__file__]
                    where = " < ".join(
                        f"{f.filename.rsplit('repro_torch/')[-1]}:{f.lineno}"
                        for f in frames[-3:][::-1])
                    sites[(name, where)] += added
            return out

    if args.layers is not None:
        dryrun.get_model_config = lambda a: get_model_config(a).replace(
            num_layers=args.layers)
    dryrun.CollectiveBytes = SiteBytes
    rec = dryrun.run_one(args.arch, args.shape, device=args.device,
                         verbose=False,
                         mesh_shape=tuple(int(n) for n in
                                          args.mesh.split("x")))
    print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "mesh",
                                              "status", "error", "where",
                                              "per_device", "trace_s")}))
    total = sum(sites.values()) or 1.0
    for (name, where), nbytes in sites.most_common(args.top):
        print(f"{nbytes / 1e9:12.3f} GB {100 * nbytes / total:5.1f}% "
              f"{name:15s} {where}")


if __name__ == "__main__":
    main()
