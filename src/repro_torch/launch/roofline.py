"""Roofline report from the dry run's JSONs (port of
``repro/launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline --glob 'results/dryrun_torch*.json'

Per (arch x shape): the three terms in seconds per step on one rank, the
dominant one, MODEL_FLOPS = 2 N_active D (inference) per rank, the
useful-compute ratio MODEL_FLOPS / counted FLOPs, and a one-line lever on
the dominant term. The terms are a model of the port's unfused eager step
against the H100 SXM data sheet's peaks (launch/op_cost.py), not
measurements.
"""
from __future__ import annotations

import argparse
import glob
import json

from repro_torch.kernels import cost as kcost

LEVERS = {
    ("memory_s", "prefill"): "fuse the attention (scores stay in shared memory, "
                             "never in HBM) and the eager elementwise chains",
    ("memory_s", "decode"): "batch up decode (cache reads amortize) / "
                            "quantize the KV cache (int8 pools)",
    ("compute_s", "prefill"): "tensor-core bound: good; tune attention chunking",
    ("compute_s", "decode"): "decode should not be compute-bound: check the MLA "
                             "absorbed-path product order",
    ("collective_s", "prefill"): "re-shard activations: keep TP collectives per "
                                 "layer, reduce-scatter instead of all-reduce",
    ("collective_s", "decode"): "replicate small KV (skip the reduction) / move "
                                "the vocabulary gather off the NVLink path",
}


def load(paths):
    recs = []
    for p in paths:
        with open(p) as f:
            recs.extend(json.load(f))
    return recs


def fmt_row(r):
    t = r["roofline"]
    ratio = r.get("useful_flops_ratio")
    lever = LEVERS.get((t["dominant"], r["kind"]), "")
    return (f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} "
            f"| {t['memory_s']:.3e} | {t['collective_s']:.3e} "
            f"| {t['dominant'].replace('_s', '')} "
            f"| {r['model_flops_per_chip']:.3e} "
            f"| {ratio:.3f} | {lever} |" if ratio is not None else "")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--glob", default="results/dryrun_torch*.json")
    ap.add_argument("--multi-pod", action="store_true",
                    help="table for the 2x16x16 mesh instead (default 16x16)")
    ap.add_argument("--md-out", default=None)
    args = ap.parse_args(argv)

    recs = load(sorted(glob.glob(args.glob)))
    rows = [r for r in recs if r.get("status") == "ok"
            and r.get("multi_pod") == args.multi_pod]
    skips = [r for r in recs if r.get("status") == "skipped"
             and r.get("multi_pod") == args.multi_pod]
    errs = [r for r in recs if r.get("status") == "error"]

    p = kcost.PEAKS
    mesh = "2x16x16 (512 ranks)" if args.multi_pod else "16x16 (256 ranks)"
    lines = [f"Mesh: {mesh}. Terms are seconds a step on one rank against the "
             f"{p['name']} peaks: {p['bf16_flop_s'] / 1e12:.1f} TF/s dense bf16, "
             f"{p['fp32_flop_s'] / 1e12:.0f} TF/s fp32, "
             f"{p['int32_op_s'] / 1e12:.2f} TOP/s int32, "
             f"{p['hbm_bytes_s'] / 1e12:.2f} TB/s HBM, "
             f"{p['nvlink_bytes_s'] / 1e9:.0f} GB/s NVLink a direction "
             "(a model, not a measurement).", "",
             "| arch | shape | compute (s) | memory (s) | collective (s) "
             "| dominant | MODEL_FLOPS/rank | useful ratio | lever on dominant term |",
             "|---|---|---|---|---|---|---|---|---|"]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(rows, key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        lines.append(fmt_row(r))
    lines.append("")
    for r in sorted(skips, key=lambda r: (r["arch"], order.get(r["shape"], 9))):
        lines.append(f"* skipped: {r['arch']} x {r['shape']} - {r['reason']}")
    for r in errs:
        lines.append(f"* ERROR: {r['arch']} x {r['shape']} "
                     f"(multi_pod={r['multi_pod']}) - {r['error']}")
    out = "\n".join(lines)
    print(out)
    if args.md_out:
        with open(args.md_out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
